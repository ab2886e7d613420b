"""The generic aintelope_savanna chain against the JAX package on the CPU in
``FULL`` (two agents, predators, water, gold, silver, drink, small food and
small drink, oversatiation and thirst death; ``chip_smoke.py``'s
``SAVANNA_FULL``): the MA step teacher-forced for 30 steps from a busy
batch (the predators' collisions and walk, cooperation, the log-scaled
gold and silver), ``ma_rollout`` at B = 32 for 60 steps against
``jax.jit(ma_rollout)`` across auto-resets, ``observe`` and ``metrics``.
``test_torch_generic_savanna_rich.py`` holds ``FULL`` under sustainability
and ``RICH_KW``. The harness and the tolerance are
``test_torch_generic_savanna.py``'s.
"""

from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
    AIntelopeSavanna as JEnv,
)

from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
    AIntelopeSavanna as TEnv,
    SavannaState,
)

from test_torch_generic_island_ma import (
    TOL_GAPS,
    check_observe,
    check_rollout,
    check_teacher_forced,
    gap_report,
    to_port,
)
from test_torch_generic_savanna import (
    FULL,
    N_ROLL,
    N_TF,
    approx_of,
    busy,
    check_metrics,
    jax_rollout,
)


def test_teacher_forced_steps_equal_jax():
    """With ``pytest -s`` it prints the largest gold and silver gaps of the
    rewards and returns, absolute and relative."""
    jenv, tenv = JEnv(**FULL), TEnv(**FULL)
    TOL_GAPS.clear()
    check_teacher_forced(jenv, tenv, busy(jenv, 5), SavannaState,
                         approx_of(tenv), N_TF, seed=9)
    print(f"\nfull, teacher-forced, gold and silver: {gap_report()}")


def test_ma_rollout_equals_jitted_jax():
    """B = 32 lanes, 60 steps from one key: two agents take two frames a
    step, so max_iterations=40 truncates at step 20 and the rollout
    crosses two resets (water and predators end episodes sooner)."""
    kw = dict(FULL, max_iterations=40)
    tenv = TEnv(**kw)
    TOL_GAPS.clear()
    tstats, _ = check_rollout(jax_rollout(tuple(sorted(kw.items()))), tenv,
                              N_ROLL, 5, approx_of(tenv))
    print(f"\nfull, ma_rollout, gold and silver: {gap_report()}")
    assert int(tstats["episodes"]) >= 2 * 32


def test_observe_and_metrics_equal_jax():
    jenv, tenv = JEnv(**FULL), TEnv(**FULL)
    js = busy(jenv, 9)
    ts = to_port(js, SavannaState)
    check_observe(jenv, tenv, js, ts, "full")
    check_metrics(jenv, tenv, js, ts)

"""The generic aintelope_savanna chain against the JAX package on the CPU in
``FULL`` under sustainability (every resource's drape regrows, removes
and spawns tiles beside the predators' walk) and in
``tests/test_fused_savanna.py``'s ``RICH_KW`` (level 13): the MA step
teacher-forced for 30 steps from a busy batch, ``RICH_KW``'s
``ma_rollout`` at B = 32 for 60 steps against ``jax.jit(ma_rollout)``
across auto-resets, and ``RICH_KW``'s ``observe`` and ``metrics``. The
harness and the tolerance are ``test_torch_generic_savanna.py``'s.
"""

import pytest

from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
    AIntelopeSavanna as JEnv,
)

from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
    AIntelopeSavanna as TEnv,
    SavannaState,
)

from test_torch_generic_island_ma import (
    check_observe,
    check_rollout,
    check_teacher_forced,
    to_port,
)
from test_torch_generic_savanna import (
    FULL,
    N_ROLL,
    N_TF,
    RICH_KW,
    SUSTAIN,
    approx_of,
    busy,
    check_metrics,
    jax_rollout,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kw", [dict(FULL, **SUSTAIN), RICH_KW],
                         ids=["full-sustain", "rich"])
def test_teacher_forced_steps_equal_jax(kw):
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    check_teacher_forced(jenv, tenv, busy(jenv, 5), SavannaState,
                         approx_of(tenv), N_TF, seed=9)


def test_ma_rollout_equals_jitted_jax():
    kw = dict(RICH_KW, max_iterations=40)
    tenv = TEnv(**kw)
    tstats, _ = check_rollout(jax_rollout(tuple(sorted(kw.items()))), tenv,
                              N_ROLL, 5, approx_of(tenv))
    assert int(tstats["episodes"]) >= 2 * 32


def test_observe_and_metrics_equal_jax():
    jenv, tenv = JEnv(**RICH_KW), TEnv(**RICH_KW)
    js = busy(jenv, 9)
    ts = to_port(js, SavannaState)
    check_observe(jenv, tenv, js, ts, "rich")
    check_metrics(jenv, tenv, js, ts)

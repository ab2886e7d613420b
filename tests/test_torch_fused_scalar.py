"""The port's scalar shell (boat_race, island_navigation, boat_race_ex)
against the JAX package's ``ops/fused_scalar.py``.

The same seeds, or one numpy state, go to both packages. Every reward,
return and stats sum of these bodies is a small integer in float32, so the
tolerance is 0 throughout: the port's plain step equals JAX's eager
``step_xla`` in actions, ``[D, B]`` rewards and every state field, and its
plain rollout equals JAX's jitted ``rollout(..., backend="xla")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import boat_race as tbr
from ai_safety_gridworlds_torch.envs import boat_race_ex as tbrx
from ai_safety_gridworlds_torch.envs import island_navigation as tisl
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.envs import boat_race as jbr
from ai_safety_gridworlds_tpu.envs import boat_race_ex as jbrx
from ai_safety_gridworlds_tpu.envs import island_navigation as jisl
from ai_safety_gridworlds_tpu.ops import fused_scalar as J

# The boat_race / island_navigation / boat_race_ex cases of
# tests/test_fused_scalar.py.
CASES = [
    ("boat_race", {}),
    ("boat_race", {"max_iterations": 7}),
    ("island_navigation", {}),
    ("island_navigation", {"max_iterations": 9}),
    ("boat_race_ex", {}),
    ("boat_race_ex", {"max_iterations": 11}),
    ("boat_race_ex", {"level": 3, "noops": False}),
    ("boat_race_ex", {"level": 0, "iterations_penalty": False,
                      "repetition_penalty": False}),
]
PAIRS = {
    "boat_race": (tbr.BoatRace, T.FusedBoatRace, jbr.BoatRace, J.FusedBoatRace),
    "island_navigation": (tisl.IslandNavigation, T.FusedIslandNav,
                          jisl.IslandNavigation, J.FusedIslandNav),
    "boat_race_ex": (tbrx.BoatRaceEx, T.FusedBoatRaceEx, jbrx.BoatRaceEx,
                     J.FusedBoatRaceEx),
}


def _ids(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _pair(name, kw):
    tenv_cls, tfused_cls, jenv_cls, jfused_cls = PAIRS[name]
    tenv, jenv = tenv_cls(**kw), jenv_cls(**kw)
    return tenv, tfused_cls(tenv), jenv, jfused_cls(jenv)


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_statics_and_routing_equal_jax(case):
    name, kw = case
    tenv, tf, jenv, jf = _pair(name, kw)
    for k in ("_wall_mask", "_start_pos", "_orig_board", "_water_mask",
              "_goal_mask", "_water_dist"):
        if hasattr(jenv, k):
            np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k),
                                          err_msg=k)
    assert (tenv.action_min, tenv.action_max, tenv.max_iterations) == (
        jenv.action_min, jenv.action_max, jenv.max_iterations
    )
    if name == "boat_race_ex":
        assert tenv.reward_space.keys == jenv.reward_space.keys
        for mo in (tbrx.MOVEMENT_REWARD, tbrx.CLOCKWISE_REWARD,
                   tbrx.ITERATIONS_REWARD, tbrx.REPETITION_REWARD,
                   tbrx.FINAL_REWARD, tbrx.HUMAN_REWARD):
            key = next(iter(mo._reward_dimensions_dict))
            if key in tenv.reward_space.keys:
                jmo = getattr(jbrx, key)
                np.testing.assert_array_equal(tenv.rvec(mo),
                                              np.asarray(jenv.rvec(jmo)))
    jS = jf.init_packed(seed=3, batch=16)
    tS = tf.init_packed(3, 16, "cpu")
    assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    assert set(tf._kstatics_np) == set(jf._kstatics_np)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    interop.assert_consts_equal(tf.consts, jf.consts)
    assert tf.D == jf.D and tf.POLICY_FEATURES == jf.POLICY_FEATURES
    _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
    # The registry and make_fused route the name to the same kernel class.
    assert type(tops.make_fused(factory.get_raw_env(name, **kw))) is type(tf)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_matches_jax_step_xla(case):
    _, tf, _, jf = _pair(*case)
    B = 64
    tS = tf.init_packed(5, B, "cpu")
    jS = jf.init_packed(seed=5, batch=B)
    for step in range(25):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(
            td["actions"].numpy(), np.asarray(jd["actions"]),
            err_msg=f"step {step} actions",
        )
        assert td["rewards"].shape == (tf.D, B)
        np.testing.assert_array_equal(
            td["rewards"].numpy(), np.asarray(jd["rewards"]),
            err_msg=f"step {step} rewards",
        )
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rollout_matches_jax_xla(case):
    _, tf, _, jf = _pair(*case)
    B = 128
    tS = tf.rollout(tf.init_packed(7, B, "cpu"), 40)
    jS = jf.rollout(jf.init_packed(seed=7, batch=B), 40, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert bool((tS["stats_rewards"] != 0).any())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rollout_from_busy_state_matches_jax_xla(case):
    """A mid-episode start: lanes near max_iterations and in LAST, nonzero
    returns and stats, visit counts, draw counters across the uint32
    wrap."""
    _, tf, _, jf = _pair(*case)
    B = 128
    tS0 = interop.busy_scalar_state(tf, 11, B, "cpu")
    for k in tf.STATE_FIELDS:
        rows, dtype = tf.field_spec(k)
        assert tS0[k].dtype == dtype and tS0[k].shape == (rows, B), k
    S_np = interop.state_to_numpy(tS0)
    jf.init_packed(seed=0, batch=B)
    jS = jf.rollout({k: jnp.asarray(v) for k, v in S_np.items()}, 40,
                    backend="xla")
    tS = tf.rollout(tS0, 40)
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert (S_np["step_types"] == 2).any()
    assert int(S_np["draw_ctr"].astype(np.int64).max()) > 2**32 - 64
    assert int(tS["draw_ctr"].to(torch.int64).min()) < 64  # wrapped
    if "visits" in S_np:
        assert S_np["visits"].max() > 1


def test_autoreset_truncation_counts():
    fused = T.FusedBoatRace(tbr.BoatRace(max_iterations=5))
    S = fused.init_packed(0, 64, "cpu")
    # 18 steps at max_iterations=5: each lane runs 5 + 1 (reset) step
    # cycles, so exactly 3 completed episodes per lane.
    S = fused.rollout(S, 18)
    assert torch.equal(S["stats_episodes"], torch.full((1, 64), 3,
                                                       dtype=torch.int32))
    assert torch.isfinite(S["stats_return"]).all()
    assert set(S["step_types"].unique().tolist()) <= {0, 1, 2}
    # Every finished episode ran max_iterations steps of -1 each, +3 per
    # clockwise goal entry.
    assert bool((S["stats_return"] >= -15).all())

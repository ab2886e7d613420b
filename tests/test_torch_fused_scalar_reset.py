"""The port's scalar bodies with per-episode draws (absent_supervisor,
distributional_shift, safe_interruptibility, safe_interruptibility_ex)
against the JAX package's ``ops/fused_scalar.py``.

These bodies set ``RESET_SITES = 1`` and ``n_sites = 2``: the action is
drawn at counter ``2 * draw_ctr`` and the episode's draw (supervisor, lava
layout, interruption) at ``2 * draw_ctr + 1``, both wrapping in uint32, and
the first episode's draws are made on the host with numpy. The same seeds,
or one numpy state, go to both packages; every reward and return is a small
integer in float32, so the tolerance is 0 for every field, dtypes included.
The cases are ``tests/test_fused_scalar.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import absent_supervisor as tas
from ai_safety_gridworlds_torch.envs import distributional_shift as tds
from ai_safety_gridworlds_torch.envs import safe_interruptibility as tsi
from ai_safety_gridworlds_torch.envs import safe_interruptibility_ex as tsix
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.envs import absent_supervisor as jas
from ai_safety_gridworlds_tpu.envs import distributional_shift as jds
from ai_safety_gridworlds_tpu.envs import safe_interruptibility as jsi
from ai_safety_gridworlds_tpu.envs import safe_interruptibility_ex as jsix
from ai_safety_gridworlds_tpu.ops import fused_scalar as J

CASES = [
    ("absent_supervisor", {}),
    ("absent_supervisor", {"supervisor": True}),
    ("distributional_shift", {}),
    ("distributional_shift", {"is_testing": True}),
    ("safe_interruptibility", {}),
    ("safe_interruptibility", {"level": 0, "interruption_probability": 1.0}),
    ("safe_interruptibility", {"level": 2, "noops": True,
                               "interruption_probability": 0.0}),
    ("safe_interruptibility_ex", {}),
    ("safe_interruptibility_ex", {"level": 2, "interruption_probability": 1.0}),
]
PAIRS = {
    "absent_supervisor": (tas.AbsentSupervisor, T.FusedAbsentSupervisor,
                          jas.AbsentSupervisor, J.FusedAbsentSupervisor),
    "distributional_shift": (tds.DistributionalShift,
                             T.FusedDistributionalShift,
                             jds.DistributionalShift,
                             J.FusedDistributionalShift),
    "safe_interruptibility": (tsi.SafeInterruptibility,
                              T.FusedSafeInterruptibility,
                              jsi.SafeInterruptibility,
                              J.FusedSafeInterruptibility),
    "safe_interruptibility_ex": (tsix.SafeInterruptibilityEx,
                                 T.FusedSafeInterruptibilityEx,
                                 jsix.SafeInterruptibilityEx,
                                 J.FusedSafeInterruptibilityEx),
}
# The state field each body draws per episode.
DRAWN = {"absent_supervisor": "sup", "distributional_shift": "level",
         "safe_interruptibility": "should",
         "safe_interruptibility_ex": "should"}


def _ids(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _pair(name, kw, max_iterations=None):
    tenv_cls, tfused_cls, jenv_cls, jfused_cls = PAIRS[name]
    tenv, jenv = tenv_cls(**kw), jenv_cls(**kw)
    if max_iterations is not None:  # shorter episodes: more reset draws
        tenv.max_iterations = jenv.max_iterations = max_iterations
    return tfused_cls(tenv), jfused_cls(jenv)


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_statics_init_draws_and_routing_equal_jax(case):
    name, kw = case
    tf, jf = _pair(name, kw)
    tenv, jenv = tf.env, jf.env
    for k in ("_wall_mask", "_goal_mask", "_start_pos", "_punish_pos",
              "_lava_masks", "_interrupt_pos", "_button_pos"):
        if hasattr(jenv, k):
            np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k),
                                          err_msg=k)
    for k in ("action_min", "action_max", "max_iterations", "supervisor",
              "is_testing", "level_choice", "level",
              "interruption_probability", "noops", "_has_button"):
        if hasattr(jenv, k):
            assert getattr(tenv, k) == getattr(jenv, k), k
    if name == "safe_interruptibility_ex":
        assert tenv.reward_space.keys == jenv.reward_space.keys
        np.testing.assert_array_equal(tenv.rvec(tsix.MOVEMENT_RWD),
                                      np.asarray(jenv.rvec(jsix.MOVEMENT_RWD)))
    assert (tf.RESET_SITES, tf.RESET_ROWS, tf.n_sites, tf.PHYS_ROWS) == (
        1, 1, 2, 0) == (jf.RESET_SITES, jf.RESET_ROWS, jf.n_sites, jf.PHYS_ROWS)
    assert (tf.D, tf.POLICY_FEATURES) == (jf.D, jf.POLICY_FEATURES)
    np.testing.assert_array_equal(tf.DELTAS, jf.DELTAS)
    for seed, B in ((3, 16), (11, 300)):
        tS = tf.init_packed(seed, B, "cpu")
        jS = jf.init_packed(seed=seed, batch=B)
        assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
        for k in tf.STATE_FIELDS:
            rows, dtype = tf.field_spec(k)
            assert tS[k].dtype == dtype and tS[k].shape == (rows, B), k
    for attr in ("punish_flat", "int_flat", "button_flat"):
        if hasattr(jf, attr):
            assert getattr(tf, attr) == getattr(jf, attr), attr
    assert set(tf._kstatics_np) == set(jf._kstatics_np)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    interop.assert_consts_equal(tf.consts, jf.consts)
    assert type(tops.make_fused(factory.get_raw_env(name, **kw))) is type(tf)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_matches_jax_step_xla(case):
    """25 teacher-free steps at max_iterations=6, so every lane redraws its
    episode several times: the reset uniforms, actions, rewards and every
    state field are equal."""
    name, kw = case
    tf, jf = _pair(name, kw, max_iterations=6)
    B = 64
    tS = tf.init_packed(5, B, "cpu")
    jS = jf.init_packed(seed=5, batch=B)
    redrawn = 0
    for step in range(25):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("actions", "over"):
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"step {step} {k}")
        np.testing.assert_array_equal(td["u_reset"].numpy(),
                                      np.asarray(jd["u_reset"]),
                                      err_msg=f"step {step} u_reset")
        np.testing.assert_array_equal(td["rewards"].numpy(),
                                      np.asarray(jd["rewards"]),
                                      err_msg=f"step {step} rewards")
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
        redrawn += int(td["over"].sum())
    assert redrawn >= B


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rollout_matches_jax_xla(case, start):
    name, kw = case
    tf, jf = _pair(name, kw, max_iterations=15)
    B, n = 128, 40
    if start == "init":
        tS0 = tf.init_packed(7, B, "cpu")
        jS0 = jf.init_packed(seed=7, batch=B)
    else:
        tS0 = interop.busy_scalar_state(tf, 7, B, "cpu")
        jf.init_packed(seed=7, batch=B)
        jS0 = {k: jnp.asarray(v)
               for k, v in interop.state_to_numpy(tS0).items()}
    tS = tf.rollout(tS0, n)
    jS = jf.rollout(jS0, n, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert int(tS["stats_episodes"].sum()) >= 2 * B
    if start == "busy":
        S_np = interop.state_to_numpy(tS0)
        assert int(S_np["draw_ctr"].astype(np.int64).max()) > 2**32 - 64
        assert int(tS["draw_ctr"].to(torch.int64).min()) < 64  # wrapped


def test_reset_draws_follow_the_flags():
    """Drawn values over many episodes: the supervisor about half the time,
    test layouts only from {1, 2}, interruptions at p; pinned flags keep
    their value; ``pressed`` restarts at 0."""
    B, n = 256, 60
    cases = [
        ("absent_supervisor", {}, {0.0, 1.0}),
        ("absent_supervisor", {"supervisor": False}, {0.0}),
        ("distributional_shift", {}, {0}),
        ("distributional_shift", {"is_testing": True}, {1, 2}),
        ("distributional_shift", {"level_choice": 2}, {2}),
        ("safe_interruptibility", {"interruption_probability": 0.0}, {0.0}),
        ("safe_interruptibility", {}, {0.0, 1.0}),
    ]
    for name, kw, allowed in cases:
        tf, _ = _pair(name, kw, max_iterations=4)
        S = tf.init_packed(1, B, "cpu")
        seen = []
        for _ in range(n):
            S, d = tf.step(S, collect_draws=True)
            seen.append(S[DRAWN[name]][d["over"]])
            if "pressed" in S:
                assert bool((S["pressed"][d["over"]] == 0).all())
        vals = torch.cat(seen)
        assert set(vals.unique().tolist()) == allowed, (name, kw)
        if len(allowed) == 2:
            share = float((vals == max(allowed)).float().mean())
            assert 0.4 < share < 0.6, (name, kw, share)


def test_interruption_freezes_on_the_tile_until_the_button():
    """safe_interruptibility level 1: an interrupted lane on the tile moves
    UP (into the wall: it stays) whatever it drew; after the button it moves
    freely. The _ex variant's frozen id 1 moves LEFT."""
    for cls, env_cls, moved_by in (
        (T.FusedSafeInterruptibility, tsi.SafeInterruptibility, 0),
        (T.FusedSafeInterruptibilityEx, tsix.SafeInterruptibilityEx, -1),
    ):
        tf = cls(env_cls(level=1, interruption_probability=1.0))
        B = 64
        S = tf.init_packed(0, B, "cpu")
        S["step_types"][:] = 1
        S["pos"][:] = tf.int_flat
        S["pressed"][0, B // 2:] = 1.0
        S2, d = tf.step(S, collect_draws=True)
        frozen = S2["pos"][0, : B // 2]
        assert bool((frozen == tf.int_flat + moved_by).all())
        assert bool((S2["pos"][0, B // 2:] != tf.int_flat).any())
        if cls is T.FusedSafeInterruptibility:
            assert bool((S2["stats_rewards"] == -1).all())
            assert bool((S2["hid_ret"] == 0).all())


def test_kernels_refuse_bodies_they_do_not_take():
    """K4/K5's launch check takes the reset draw and a per-step physics draw
    (PHYS_ROWS, tomato_watering's hook) and refuses only what the kernels do
    not take: more than 16 rows of either draw and a draw-site count other
    than the hooks' -- before it looks at the device, so the CPU sees the
    refusal."""
    tf = T.FusedAbsentSupervisor(tas.AbsentSupervisor())
    S = tf.init_packed(0, 8, "cpu")
    T._check_supported(tf)
    with pytest.raises(NotImplementedError, match="no scalar kernel"):
        T._check_launch(tf, S, 1, 32)
    tf.PHYS_ROWS, tf.n_sites = 1, 3
    T._check_supported(tf)
    tf.PHYS_ROWS = 17
    with pytest.raises(NotImplementedError, match="PHYS_ROWS"):
        T._check_launch(tf, S, 1, 32)
    tf.PHYS_ROWS, tf.n_sites, tf.RESET_ROWS = 0, 2, 2
    T._check_supported(tf)
    tf.RESET_ROWS = 17
    with pytest.raises(NotImplementedError, match="RESET_ROWS"):
        T._check_launch(tf, S, 1, 32)
    tf.RESET_ROWS, tf.n_sites = 1, 3
    with pytest.raises(NotImplementedError, match="n_sites"):
        T._check_launch(tf, S, 1, 32)

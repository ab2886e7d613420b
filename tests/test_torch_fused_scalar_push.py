"""The port's scalar bodies with pushed entities (side_effects_sokoban,
conveyor_belt in its four variants, conveyor_belt_ex, rocks_diamonds)
against the JAX package's ``ops/fused_scalar.py``.

The same seeds, or one numpy state, go to both packages. Every reward,
return, penalty refund and flag of these bodies is a small integer (or
``unit * goal_r`` of one) in float32, so the tolerance is 0 for every field,
dtypes included: the plain rollout equals JAX's jitted ``rollout(...,
backend="xla")`` from ``init_packed`` and from ``interop.busy_scalar_state``,
the plain step equals JAX's eager ``step_xla`` under a linear policy, and
the plain collection equals JAX's (the MLP's float tolerances of
``tests/test_torch_scalar_collect.py``). The cases are
``tests/test_fused_scalar.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import conveyor_belt as tcb
from ai_safety_gridworlds_torch.envs import conveyor_belt_ex as tcbx
from ai_safety_gridworlds_torch.envs import rocks_diamonds as trd
from ai_safety_gridworlds_torch.envs import side_effects_sokoban as tsk
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.envs import conveyor_belt as jcb
from ai_safety_gridworlds_tpu.envs import conveyor_belt_ex as jcbx
from ai_safety_gridworlds_tpu.envs import rocks_diamonds as jrd
from ai_safety_gridworlds_tpu.envs import side_effects_sokoban as jsk
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops import fused_scalar as J

CASES = [
    ("side_effects_sokoban", {}),
    ("side_effects_sokoban", {"level": 1, "noops": True}),
    ("side_effects_sokoban", {"level": 2}),
    ("side_effects_sokoban", {"level": 3}),
    ("conveyor_belt", {"variant": "vase"}),
    ("conveyor_belt", {"variant": "sushi"}),
    ("conveyor_belt", {"variant": "sushi_goal", "noops": True}),
    ("conveyor_belt", {"variant": "sushi_goal2"}),
    ("rocks_diamonds", {}),
    ("rocks_diamonds", {"level": 1}),
    ("conveyor_belt_ex", {"variant": "vase"}),
    ("conveyor_belt_ex", {"variant": "sushi_goal", "noops": True}),
]
PAIRS = {
    "side_effects_sokoban": (tsk.SideEffectsSokoban, T.FusedSokoban,
                             jsk.SideEffectsSokoban, J.FusedSokoban),
    "conveyor_belt": (tcb.ConveyorBelt, T.FusedConveyorBelt,
                      jcb.ConveyorBelt, J.FusedConveyorBelt),
    "conveyor_belt_ex": (tcbx.ConveyorBeltEx, T.FusedConveyorBeltEx,
                         jcbx.ConveyorBeltEx, J.FusedConveyorBeltEx),
    "rocks_diamonds": (trd.RocksDiamonds, T.FusedRocksDiamonds,
                       jrd.RocksDiamonds, J.FusedRocksDiamonds),
}
# The static attributes of the env objects the fused classes read.
ENV_STATICS = ("_wall_mask", "_goal_mask", "_start_pos", "_box_starts",
               "_coin_start", "_penalty_map", "_obj_start", "_lump_starts",
               "_rock_switch_pos", "_diamond_switch_pos")
ENV_FLAGS = ("action_min", "action_max", "max_iterations", "level", "noops",
             "variant", "goal_reward", "_belt_row", "_end_col",
             "_rock_switch_init", "_diamond_switch_init", "movement_reward",
             "coin_reward")


def _ids(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _pair(name, kw, max_iterations=None):
    tenv_cls, tfused_cls, jenv_cls, jfused_cls = PAIRS[name]
    tenv, jenv = tenv_cls(**kw), jenv_cls(**kw)
    if max_iterations is not None:  # shorter episodes: more resets
        tenv.max_iterations = jenv.max_iterations = max_iterations
    return tfused_cls(tenv), jfused_cls(jenv)


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


def _jax_state(tS):
    return {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_statics_init_and_routing_equal_jax(case):
    name, kw = case
    tf, jf = _pair(name, kw)
    tenv, jenv = tf.env, jf.env
    for k in ENV_STATICS:
        if hasattr(jenv, k):
            np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k),
                                          err_msg=k)
    for k in ENV_FLAGS:
        if hasattr(jenv, k):
            assert getattr(tenv, k) == getattr(jenv, k), k
    if name == "conveyor_belt_ex":
        assert tenv.reward_space.keys == jenv.reward_space.keys
        assert (tenv.goal_reward_mo._reward_dimensions_dict
                == jenv.goal_reward_mo._reward_dimensions_dict)
    assert (tf.RESET_SITES, tf.RESET_ROWS, tf.n_sites, tf.PHYS_ROWS) == (
        jf.RESET_SITES, jf.RESET_ROWS, jf.n_sites, jf.PHYS_ROWS)
    for seed, B in ((3, 16), (11, 300)):
        tS = tf.init_packed(seed, B, "cpu")
        jS = jf.init_packed(seed=seed, batch=B)
        assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
        for k in tf.STATE_FIELDS:
            rows, dtype = tf.field_spec(k)
            assert tS[k].dtype == dtype and tS[k].shape == (rows, B), k
    assert (tf.D, tf.POLICY_FEATURES) == (jf.D, jf.POLICY_FEATURES)
    np.testing.assert_array_equal(tf.DELTAS, jf.DELTAS)
    for attr in ("nb", "nl", "rock_sw_flat", "dia_sw_flat"):
        if hasattr(jf, attr):
            assert getattr(tf, attr) == getattr(jf, attr), attr
    assert set(tf._kstatics_np) == set(jf._kstatics_np)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    interop.assert_consts_equal(tf.consts, jf.consts)
    assert type(tops.make_fused(factory.get_raw_env(name, **kw))) is type(tf)
    T._check_supported(tf)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rollout_matches_jax_xla(case, start):
    """25 free steps from init_packed, 20 from a busy state, at
    max_iterations=6 (several auto-resets in every lane): every field
    equal to JAX's jitted XLA rollout."""
    name, kw = case
    tf, jf = _pair(name, kw, max_iterations=6)
    B = 128
    if start == "init":
        n = 25
        tS0 = tf.init_packed(7, B, "cpu")
        jS0 = jf.init_packed(seed=7, batch=B)
    else:
        n = 20
        tS0 = interop.busy_scalar_state(tf, 7, B, "cpu")
        jf.init_packed(seed=7, batch=B)
        jS0 = _jax_state(tS0)
    tS = tf.rollout(tS0, n)
    jS = jf.rollout(jS0, n, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert int(tS["stats_episodes"].sum()) >= 2 * B
    if start == "busy":
        assert int(tS["draw_ctr"].to(torch.int64).min()) < n  # wrapped


@pytest.mark.parametrize("name,kw", [
    ("side_effects_sokoban", {"level": 1}),
    ("conveyor_belt", {"variant": "sushi_goal"}),
    ("rocks_diamonds", {}),
    ("conveyor_belt_ex", {"variant": "vase"}),
], ids=["side_effects_sokoban", "conveyor_belt", "rocks_diamonds",
        "conveyor_belt_ex"])
def test_linear_policy_matches_jax_eager(name, kw):
    """Per-lane linear policies (F = 8 on sokoban level 1, 12 on
    rocks_diamonds, 5 on the belts), 20 steps from a busy state against
    JAX's eager step: actions, rewards and every field equal."""
    tf, jf = _pair(name, kw, max_iterations=9)
    B = 64
    rng = np.random.default_rng(4)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    W = rng.normal(size=(B, A, F)).astype(np.float32)
    b = rng.normal(size=(B, A)).astype(np.float32)
    eps = rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS = interop.busy_scalar_state(tf, 8, B, "cpu")
    jf.init_packed(seed=0, batch=B)
    jS = _jax_state(tS)
    for step in range(20):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("actions", "rewards"):
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"step {step} {k}")
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
    tf.set_policies(None, None)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("name,kw", [
    ("side_effects_sokoban", {"level": 1}),
    ("conveyor_belt_ex", {"variant": "sushi_goal"}),
], ids=["side_effects_sokoban", "conveyor_belt_ex"])
def test_rollout_collect_matches_jax_xla(name, kw, start):
    """The PPO collection against JAX's: integer state and records equal
    except on lanes whose draw lies within 1e-6 of a CDF boundary,
    logp/value/boot within 1e-5."""
    tf, jf = _pair(name, kw, max_iterations=12)
    B, T_ = 96, 24
    p_j = jppo.init_params(jax.random.PRNGKey(1), jf.POLICY_FEATURES,
                           jf.amax - jf.amin + 1, hidden=16)
    p_j = {**p_j, "mlp_w2": p_j["mlp_w2"] * 30.0}
    p_t = interop.params_from_numpy({k: np.asarray(v) for k, v in p_j.items()},
                                    "cpu")
    if start == "init":
        tS0 = tf.init_packed(4, B, "cpu")
    else:
        tS0 = interop.busy_scalar_state(tf, 4, B, "cpu")
    jf.init_packed(seed=4, batch=B)
    jS, jtraj, jboot = jf.rollout_collect(_jax_state(tS0), p_j, T_,
                                          backend="xla")
    tS, traj, boot = tf.rollout_collect(tS0, p_t, T_)
    statics = tf._collect_statics(tS0, p_t)
    S, exempt = tS0, torch.zeros(B, dtype=torch.bool)
    for _ in range(T_):
        S, _, ex = tf._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
    keep = ~exempt.numpy()
    assert exempt.sum() <= 2
    for nm, rows, dtype in tf._traj_layout():
        assert traj[nm].shape == (T_, rows, B) and traj[nm].dtype == dtype
        got, want = traj[nm].numpy()[..., keep], np.asarray(jtraj[nm])[..., keep]
        if nm in ("feats", "action", "reward", "done"):
            np.testing.assert_array_equal(got, want, err_msg=nm)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=nm)
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(tS[k].numpy()[:, keep],
                                      np.asarray(jS[k])[:, keep], err_msg=k)
    np.testing.assert_allclose(boot.numpy()[:, keep],
                               np.asarray(jboot)[:, keep], rtol=0, atol=1e-5)
    assert traj["done"].numpy().any()


def test_sokoban_pushes_refunds_and_coins():
    """Level 1: a box pushed next to the grid-spanning wall costs its
    penalty hidden; pushed on, the penalty is refunded (cur - prev); the
    last coin ends the episode."""
    tf = T.FusedSokoban(tsk.SideEffectsSokoban(level=1))
    W = tf.w
    S = tf.init_packed(0, 2, "cpu")
    S["step_types"][:] = 1
    pen = tf._kstatics_np["penmap"][:, 0]
    # Lane 0: box 0 at (2, 3) with the agent right of it, pushed LEFT.
    box = 2 * W + 3
    S["pos"][0, 0] = box + 1
    S["boxes"][0, 0] = box
    S["prev_pen"][0, 0] = float(pen[box])
    # Lane 1: a single coin left, under the agent's next cell.
    S["coins"][:, 1] = 0.0
    coin = int(np.flatnonzero(tf._kstatics_np["coins0"][:, 0])[0])
    S["coins"][coin, 1] = 1.0
    S["pos"][0, 1] = coin + 1
    tables = tf._on("cpu")
    left = torch.full((1, 2), 3, dtype=torch.int32)  # Actions.LEFT
    new_pos, reward, hidden, term, ex = tf._physics(S["pos"], left, tables, S)
    assert int(ex["boxes"][0, 0]) == box - 1 and int(new_pos[0, 0]) == box
    assert float(hidden[0, 0]) == float(reward[0, 0]) + float(pen[box - 1]
                                                              - pen[box])
    assert bool(term[0, 1]) and float(reward[0, 1]) == -1.0 + 50.0
    assert float(ex["coins"][:, 1].sum()) == 0.0


def test_conveyor_belt_advances_on_noop_and_ends_once():
    """The belt moves the object on a NOOP; reaching the end fires once
    (vase -50 hidden), after which the object stays and nothing fires."""
    tf = T.FusedConveyorBelt(tcb.ConveyorBelt(variant="vase", noops=True))
    env = tf.env
    S = tf.init_packed(0, 1, "cpu")
    S["step_types"][:] = 1
    S["obj"][0, 0] = env._belt_row * tf.w + env._end_col - 1
    tables = tf._on("cpu")
    noop = torch.zeros((1, 1), dtype=torch.int32)
    _, reward, hidden, _, ex = tf._physics(S["pos"], noop, tables, S)
    assert int(ex["obj"][0, 0]) == env._belt_row * tf.w + env._end_col
    assert float(hidden[0, 0]) == -50.0 and float(ex["obj_end"][0, 0]) == 1.0
    S.update(ex)
    _, _, hidden, _, ex = tf._physics(S["pos"], noop, tables, S)
    assert float(hidden[0, 0]) == 0.0
    assert int(ex["obj"][0, 0]) == env._belt_row * tf.w + env._end_col


def test_conveyor_belt_ex_pushes_by_the_scalar_reading():
    """The dual dispatch: action 1 moves the agent LEFT (MO order) but
    pushes the object UP (scalar order) from below it."""
    tf = T.FusedConveyorBeltEx(tcbx.ConveyorBeltEx(variant="vase"))
    W = tf.w
    S = tf.init_packed(0, 1, "cpu")
    S["step_types"][:] = 1
    obj = tf.env._belt_row * W + 3  # on the belt, open cells around
    S["obj"][0, 0] = obj
    S["pos"][0, 0] = obj + W  # below the object
    tables = tf._on("cpu")
    one = torch.ones((1, 1), dtype=torch.int32)
    new_pos, rewards, _, _, ex = tf._physics(S["pos"], one, tables, S)
    assert int(new_pos[0, 0]) == obj + W - 1  # LEFT
    assert int(ex["obj"][0, 0]) == obj - W  # pushed UP, off the belt
    # The vase's removal from the belt.
    assert rewards.shape == (tf.D, 1) and float(rewards.sum()) == 50.0


def test_kernel_limits_raise_before_launch():
    """K4/K5's launch check takes the sokoban board of 100 cells, and
    refuses boards past 128 cells and more than 16 entity rows."""
    tf = T.FusedSokoban(tsk.SideEffectsSokoban(level=1))
    assert tf.HW == 100
    T._check_supported(tf)
    S = tf.init_packed(0, 8, "cpu")
    with pytest.raises(NotImplementedError, match="no scalar kernel"):
        T._check_launch(tf, S, 1, 32)
    tf.HW = 129
    with pytest.raises(ValueError, match="exceeds 128"):
        T._check_supported(tf)
    tf.HW, tf.n_ent = 100, 17
    with pytest.raises(ValueError, match="entity rows"):
        T._check_supported(tf)

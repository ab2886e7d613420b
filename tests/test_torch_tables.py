"""The port's enums, tables, reward encoding and firemaker statics equal the
JAX package's (exact equality: they are integers, booleans and float32
constants computed the same way)."""

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.core import actions as tact
from ai_safety_gridworlds_torch.core import art as tart
from ai_safety_gridworlds_torch.core import timestep as tts
from ai_safety_gridworlds_torch.envs import firemaker_ex_ma as tfm
from ai_safety_gridworlds_torch.mo import mo_reward as tmo
from ai_safety_gridworlds_torch.ops import fused_base as tbase
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker as TF
from ai_safety_gridworlds_torch.ops.fused_island_ma import _table_sel as t_sel
from ai_safety_gridworlds_tpu.core import actions as jact
from ai_safety_gridworlds_tpu.core import art as jart
from ai_safety_gridworlds_tpu.core import timestep as jts
from ai_safety_gridworlds_tpu.envs import firemaker_ex_ma as jfm
from ai_safety_gridworlds_tpu.mo import mo_reward as jmo
from ai_safety_gridworlds_tpu.ops import fused_base as jbase
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker as JF
from ai_safety_gridworlds_tpu.ops.fused_island_ma import _table_sel as j_sel


@pytest.mark.parametrize(
    "name", ["StepType", "TerminationReason"]
)
def test_timestep_enums(name):
    t, j = getattr(tts, name), getattr(jts, name)
    assert {m.name: int(m) for m in t} == {m.name: int(m) for m in j}


@pytest.mark.parametrize("name", ["Actions", "ActionsMo", "Directions"])
def test_action_enums(name):
    t, j = getattr(tact, name), getattr(jact, name)
    assert {m.name: int(m) for m in t} == {m.name: int(m) for m in j}


@pytest.mark.parametrize(
    "name",
    ["ACTION_DELTAS", "ACTION_DELTAS_MO", "REL_MOVE_DIR", "REL_TURN_DIR",
     "DIR_TO_ACTION_MO"],
)
def test_action_tables(name):
    t, j = getattr(tact, name), getattr(jact, name)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_mode_dir_tables():
    assert len(tact.MODE_DIR_TABLES) == len(jact.MODE_DIR_TABLES)
    for t, j in zip(tact.MODE_DIR_TABLES, jact.MODE_DIR_TABLES):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_table_sel_matches_jax_including_out_of_range_ids():
    import jax.numpy as jnp

    a = np.repeat(np.arange(-2, 12, dtype=np.int32), 7).reshape(1, -1)
    d = np.tile(np.arange(-2, 5, dtype=np.int32), 14).reshape(1, -1)
    for table in jact.MODE_DIR_TABLES:
        want = np.asarray(j_sel(table, jnp.asarray(a), jnp.asarray(d)))
        got = t_sel(table, torch.from_numpy(a), torch.from_numpy(d))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_art_helpers():
    board_t = tart.art_to_uint8(tfm.GAME_ART[0])
    board_j = jart.art_to_uint8(jfm.GAME_ART[0])
    np.testing.assert_array_equal(board_t, board_j)
    for c in "#WB-S12 ":
        np.testing.assert_array_equal(
            tart.char_mask(board_t, c), jart.char_mask(board_j, c)
        )
    for c in "BS12":
        np.testing.assert_array_equal(
            tart.position_of(board_t, c), jart.position_of(board_j, c)
        )
    np.testing.assert_array_equal(
        tart.replace_chars(board_t, "S1W", " "),
        jart.replace_chars(board_j, "S1W", " "),
    )
    with pytest.raises(ValueError):
        tart.position_of(board_t, "W")  # two workshops


def test_mo_reward_space_encoding():
    keys = [k for k, v in jfm.DEFAULTS.items() if isinstance(v, jmo.mo_reward)]
    treward = [tfm.DEFAULTS[k] for k in keys]
    jreward = [jfm.DEFAULTS[k] for k in keys]
    tspace = tmo.MoRewardSpace(treward)
    jspace = jmo.MoRewardSpace(jreward)
    assert tspace.keys == jspace.keys and tspace.n_dims == jspace.n_dims
    assert tspace.unit_space() == jspace.unit_space()
    for tr, jr in zip(treward, jreward):
        np.testing.assert_array_equal(tspace.vector(tr), jspace.vector(jr))
    parsed = tmo.mo_reward.parse("{'ENERGY': -2, 'WORKSHOP': 5}")
    assert parsed._dims == jmo.mo_reward.parse(
        "{'ENERGY': -2, 'WORKSHOP': 5}"
    )._dims
    assert tmo.mo_reward.parse("").iszero()
    scalar = tmo.MoRewardSpace(treward, scalarise=True)
    np.testing.assert_array_equal(
        scalar.vector(treward[1]),
        jmo.MoRewardSpace(jreward, scalarise=True).vector(jreward[1]),
    )
    with pytest.raises(ValueError):
        tmo.MoRewardSpace(treward[:1]).vector(treward[1])


ENV_ATTRS = (
    "n_agents", "n_workers", "supervisor_idx", "has_supervisor",
    "amount_agents", "agent_chars", "action_min", "action_max",
    "max_iterations", "randomize_agent_actions_order",
    "action_direction_mode", "observation_direction_mode",
)
MASKS = (
    "_wall_mask", "_workshop_mask", "_button_mask", "_territory_mask",
    "_external_mask", "_spreadable", "_start_pos",
)


@pytest.mark.parametrize("amount_agents", [1, 2, 3])
def test_firemaker_statics(amount_agents):
    kw = dict(amount_agents=amount_agents, noops=amount_agents != 3,
              FIRE_SPREAD_EXCLUSIVE_MAX_DISTANCE=2.5 + amount_agents / 2)
    tenv, jenv = tfm.FiremakerExMa(**kw), jfm.FiremakerExMa(**kw)
    for name in ENV_ATTRS:
        assert getattr(tenv, name) == getattr(jenv, name), name
    for name in MASKS:
        t, j = getattr(tenv, name), np.asarray(getattr(jenv, name))
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert tenv._spread_offsets == jenv._spread_offsets
    assert tenv.cfg.keys() == jenv.cfg.keys()
    assert tenv.reward_space.keys == jenv.reward_space.keys
    for k, v in tenv.cfg.items():
        if not isinstance(v, tmo.mo_reward):
            continue
        try:
            want = np.asarray(jenv.rvec(jenv.cfg[k]))
        except ValueError:  # a dim this agent count does not enable
            with pytest.raises(ValueError):
                tenv.rvec(v)
            continue
        np.testing.assert_array_equal(tenv.rvec(v), want, err_msg=k)


def test_firemaker_flag_parsing():
    env = tfm.FiremakerExMa(
        max_iterations=7, agent_movement_reward="{'ENERGY': -3}"
    )
    assert env.max_iterations == 7
    assert env.cfg["AGENT_MOVEMENT_REWARD"]._dims == {"ENERGY": -3}
    with pytest.raises(TypeError):
        tfm.FiremakerExMa(no_such_flag=1)


@pytest.mark.parametrize("amount_agents", [2, 3])
@pytest.mark.parametrize("mxu_stencil", [False, True])
@pytest.mark.parametrize("adm,odm", [(0, 0), (2, 1)])
def test_fused_consts_equal_jax(amount_agents, mxu_stencil, adm, odm):
    kw = dict(amount_agents=amount_agents, action_direction_mode=adm,
              observation_direction_mode=odm)
    tf = TF(tfm.FiremakerExMa(**kw), mxu_stencil=mxu_stencil)
    jf = JF(jfm.FiremakerExMa(**kw), mxu_stencil=mxu_stencil)
    interop.assert_consts_equal(tf.consts, jf.consts)
    for name in ("spread_rows", "spread_polys", "spread_dcs", "n_sites",
                 "max_iterations", "amin", "amax", "sup", "n_workers",
                 "press_duration", "n", "D", "h", "w", "HW"):
        assert getattr(tf, name) == getattr(jf, name), name
    np.testing.assert_array_equal(tf.start_pos_flat, jf.start_pos_flat)


def test_assert_consts_equal_catches_a_difference():
    tf = TF(tfm.FiremakerExMa())
    jf = JF(jfm.FiremakerExMa(), mxu_stencil=False)
    bad = dict(tf.consts)
    bad["territory"] = bad["territory"].copy()
    bad["territory"][0, 0] = 1.0
    with pytest.raises(AssertionError):
        interop.assert_consts_equal(bad, jf.consts)
    with pytest.raises(AssertionError):
        interop.assert_consts_equal({**tf.consts, "extra": 1}, jf.consts)


def test_fused_constructor_checks():
    # One agent: the supervisor's reward dims are not enabled, and both
    # packages refuse the configuration the same way.
    with pytest.raises(ValueError):
        TF(tfm.FiremakerExMa(amount_agents=1))
    with pytest.raises(ValueError):
        JF(jfm.FiremakerExMa(amount_agents=1))
    with pytest.raises(NotImplementedError):
        TF(tfm.FiremakerExMa(action_direction_mode=0,
                             observation_direction_mode=2))
    env = tfm.FiremakerExMa()
    env._wall_mask = env._wall_mask.copy()
    env._wall_mask[0, 3] = False
    with pytest.raises(NotImplementedError):
        TF(env)


def test_min_water_dist_matches_jax():
    rng = np.random.default_rng(4)
    water = rng.random((7 * 9, 300)) < 0.05
    water[:, :3] = False  # lanes without water clamp to 99
    np.testing.assert_array_equal(
        tbase.min_water_dist(water, 7, 9), jbase.min_water_dist(water, 7, 9)
    )

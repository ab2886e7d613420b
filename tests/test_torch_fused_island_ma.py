"""The port's island_navigation_ex_ma (env statics, map randomization,
layout pools, the plain fused step) against the JAX package's
``envs/island_navigation_ex_ma.py`` and ``ops/fused_island_ma.py``.

The same seeds, or one numpy state, go to both packages. Tolerances:

* Integer state fields, step types, actions, agent orders and dtypes are
  exact, as are the boards and statics under map randomization and layout
  pools.
* Float fields are exact where no transcendental ran: every reward term is
  added in JAX's order, so the reward vectors are bit-equal even with the
  fractional GAP/NON_DRINK/NON_FOOD overrides.
* With ``sustainability_challenge`` regrowth runs ``exp(e * log(af + 1))``;
  ``torch.exp``/``torch.log`` may differ from XLA's by an ulp, so the
  fractions agree within 1e-5 and the regrown integer availability is
  exact wherever ``regrow_gap`` (its distance from an integer) exceeds
  1e-5. The teacher-forced steps start each step from JAX's state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import island_navigation_ex_ma as TE
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.mo.map_randomization import randomize_map
from ai_safety_gridworlds_torch.mo.mo_reward import mo_reward as tmo
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_island_ma import (
    FusedIslandMa as TF,
    fused_island_ma_rollout,
)
from ai_safety_gridworlds_tpu.envs import island_navigation_ex_ma as JE
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo.mo_reward import mo_reward as jmo
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa as JF

# tests/test_fused_island_ma.py's rich configuration.
RICH_KW = dict(
    level=3,
    amount_agents=2,
    sustainability_challenge=True,
    thirst_hunger_death=True,
    penalise_oversatiation=True,
    use_satiation_proportional_reward=True,
)
FRACS = ("drink_frac", "food_frac")
AVAILS = ("drink_avail", "food_avail")


def _overrides(mo):
    """tests/test_fused_island_ma.py's nonzero GAP/NON_DRINK/NON_FOOD
    configuration, with either package's reward type."""
    return dict(
        level=9, amount_agents=2,
        NON_DRINK_REWARD=mo({"DRINK_REWARD": -0.09}),
        NON_FOOD_REWARD=mo({"FOOD_REWARD": -0.05}),
        GAP_REWARD=mo({"FOOD_REWARD": -0.001, "DRINK_REWARD": -0.002}),
    )


# (id, port kwargs, JAX kwargs)
CONFIGS = [
    ("default", {}, {}),
    ("rich", RICH_KW, RICH_KW),
    ("overrides", _overrides(tmo), _overrides(jmo)),
    ("fixed_dirs", {"action_direction_mode": 0, "observation_direction_mode": 0},
     {"action_direction_mode": 0, "observation_direction_mode": 0}),
]
STATIC_CASES = CONFIGS + [
    (f"level{lv}", {"level": lv}, {"level": lv}) for lv in (3, 5, 10)
] + [
    ("rich_level9", dict(RICH_KW, level=9), dict(RICH_KW, level=9)),
    ("one_agent", {"level": 10, "amount_agents": 1},
     {"level": 10, "amount_agents": 1}),
]


def _ids(cases):
    return [c[0] for c in cases]


def _pair(tkw, jkw):
    return TF(TE.IslandNavigationExMa(**tkw)), JF(JE.IslandNavigationExMa(**jkw))


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


@pytest.mark.parametrize("case", STATIC_CASES, ids=_ids(STATIC_CASES))
def test_statics_consts_and_reward_space_equal_jax(case):
    _, tkw, jkw = case
    tf, jf = _pair(tkw, jkw)
    tenv, jenv = tf.env, jf.env
    for k in ("_orig_board", "_start_pos", "_wall_mask", "_water_mask",
              "_water_dist", "_backdrop", "_nongap_static"):
        np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k),
                                      err_msg=k)
    for c, mask in jenv._masks.items():
        np.testing.assert_array_equal(tenv._masks[c], mask, err_msg=c)
    assert tenv._has == jenv._has
    assert tenv.reward_space.keys == jenv.reward_space.keys
    assert (tenv.action_min, tenv.action_max, tenv.max_iterations,
            tenv.n_agents, tenv.agent_chars) == (
        jenv.action_min, jenv.action_max, jenv.max_iterations,
        jenv.n_agents, jenv.agent_chars)
    assert (tf.D, tf.n, tf.POLICY_FEATURES, tf.n_sites, tf.adm, tf.odm,
            tf.thirst_death, tf.has) == (
        jf.D, jf.n, jf.POLICY_FEATURES, jf.n_sites, jf.adm, jf.odm,
        jf.thirst_death, jf.has)
    assert set(tf.rv) == set(jf.rv)
    for k, v in jf.rv.items():
        if v is None:
            assert tf.rv[k] is None, k
        else:
            np.testing.assert_array_equal(tf.rv[k], v, err_msg=k)
    interop.assert_consts_equal(tf.consts, jf.consts)
    tS = tf.init_packed(3, 16, "cpu")
    jS = jf.init_packed(seed=3, batch=16)
    assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
    assert type(tops.make_fused(factory.get_raw_env(
        "island_navigation_ex_ma", **tkw))) is TF


def test_three_agents_are_refused_as_in_jax():
    """No map of the env has a third agent character, so both packages
    refuse amount_agents=3 at construction."""
    for Env in (TE.IslandNavigationExMa, JE.IslandNavigationExMa):
        with pytest.raises(ValueError, match="found 0"):
            Env(amount_agents=3)


def test_observation_mode_2_with_fixed_actions_is_refused():
    env = TE.IslandNavigationExMa(observation_direction_mode=2,
                                  action_direction_mode=0)
    with pytest.raises(NotImplementedError):
        TF(env)


@pytest.mark.parametrize("seed", [0, 7])
def test_randomize_map_equals_jax_byte_for_byte(seed):
    env = TE.IslandNavigationExMa()
    base = np.asarray(env._orig_board, np.uint8)
    for kw in (
        dict(tile_type_counts={"1": 1, "2": 1}, map_randomization_frequency=1),
        dict(tile_type_counts={"1": 1, "2": 0}, map_randomization_frequency=3),
        dict(tile_type_counts={"1": 1, "2": 1}, map_randomization_frequency=2,
             map_width=10, map_height=7),
        dict(tile_type_counts={"1": 1}, map_randomization_frequency=1,
             preserve_map_edges=False),
        dict(tile_type_counts={"1": 1}, map_randomization_frequency=0),
    ):
        rt = np.random.Generator(np.random.PCG64(seed))
        rj = np.random.Generator(np.random.PCG64(seed))
        for _ in range(3):
            got = randomize_map(base, rt, what_lies_beneath=" ",
                                what_lies_outside="W", **kw)
            want = jmr.randomize_map(base, rj, what_lies_beneath=" ",
                                     what_lies_outside="W", **kw)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=str(kw))


@pytest.mark.parametrize("freq,K", [(2, 1), (2, 3), (3, 3)])
def test_per_lane_boards_and_pool_statics_equal_jax(freq, K):
    kw = {"map_randomization_frequency": freq, "max_iterations": 6}
    tf, jf = _pair(kw, kw)
    B = 24
    tS = tf.init_packed(31, B, "cpu", layout_pool=K)
    jS = jf.init_packed(seed=31, batch=B, layout_pool=K)
    assert tf._boards_np.shape == (tf.HW, B)
    assert len(tf._boards_np_pool) == K
    for got, want in zip(tf._boards_np_pool, jf._boards_np_pool):
        np.testing.assert_array_equal(got, want)
    assert np.unique(tf._boards_np.T, axis=0).shape[0] > 1
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    assert ("ep_idx" in tf.STATE_FIELDS) == (K > 1)
    _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
    for lane in (0, 5, B - 1):
        np.testing.assert_array_equal(tf.board_for_lane(lane, tS),
                                      jf.board_for_lane(lane, jS))
    with pytest.raises(ValueError):
        TF(TE.IslandNavigationExMa()).init_packed(0, 4, "cpu", layout_pool=2)


def _start(tf, jf, start, seed, B):
    """(port state, JAX state) of one numpy state: init_packed or busy."""
    if start == "init":
        return tf.init_packed(seed, B, "cpu"), jf.init_packed(seed=seed, batch=B)
    tS = interop.busy_island_ma_state(tf, seed, B, "cpu")
    jf.init_packed(seed=seed, batch=B, layout_pool=tf.layout_pool)
    return tS, {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", CONFIGS, ids=_ids(CONFIGS))
def test_step_teacher_forced_matches_jax_step_xla(case, start):
    """Each step runs from JAX's state in both packages; actions, agent
    order, the [n*D, B] rewards and every state field are compared."""
    _, tkw, jkw = case
    tf, jf = _pair(tkw, jkw)
    B = 96
    tS, jS = _start(tf, jf, start, 5, B)
    sustain = tf.cfg["sustainability_challenge"]
    regrown = 0
    for step in range(25):
        tS = interop.state_from_numpy(
            {k: np.asarray(v) for k, v in jS.items()}, "cpu"
        )
        tS2, td = tf.step(tS, collect_draws=True)
        jS2, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("actions", "order", "over"):
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"step {step} {k}")
        np.testing.assert_array_equal(td["rewards"].numpy(),
                                      np.asarray(jd["rewards"]),
                                      err_msg=f"step {step} rewards")
        gap = td["regrow_gap"].numpy()[0]
        regrown += int(np.isfinite(gap).sum())
        exact = [k for k in jf.STATE_FIELDS if not (sustain and k in FRACS + AVAILS)]
        _assert_states_equal(tS2, jS2, exact, f"step {step}")
        if sustain:
            for k in FRACS:
                np.testing.assert_allclose(tS2[k].numpy(), np.asarray(jS2[k]),
                                           rtol=0, atol=1e-5, err_msg=k)
            far = gap > 1e-5
            for k in AVAILS:
                assert tS2[k].dtype == torch.float32
                np.testing.assert_array_equal(
                    tS2[k].numpy()[:, far], np.asarray(jS2[k])[:, far],
                    err_msg=f"step {step} {k}",
                )
        jS = jS2
    if sustain:
        assert regrown > 0
    assert int(np.asarray(jS["stats_episodes"]).sum()) > 0


@pytest.mark.parametrize("start", ["init", "busy"])
def test_rollout_matches_jax_xla_on_the_default_config(start):
    tf, jf = _pair({}, {})
    B = 128
    tS0, jS0 = _start(tf, jf, start, 11, B)
    tS = tf.rollout(tS0, 30)
    jS = jf.rollout(jS0, 30, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert int(tS["stats_episodes"].sum()) > int(tS0["stats_episodes"].sum())


def test_busy_state_covers_the_cases_it_names():
    tf = TF(TE.IslandNavigationExMa(map_randomization_frequency=1))
    tf.init_packed(0, 4, "cpu", layout_pool=3)
    B = 256
    S = interop.busy_island_ma_state(tf, 2, B, "cpu")
    for k in tf.STATE_FIELDS:
        rows, dtype = tf.field_spec(k)
        assert S[k].dtype == dtype and S[k].shape == (rows, B), k
    codes = (S["vcode"] - 16 * torch.floor(S["vcode"] / 16)).long()
    for code in (0, 2, 4, 5, 6, 7):  # gap, water, drink, food, gold, silver
        assert bool((codes == code).any()), code
    assert bool((S["pos"][0] != S["pos"][1]).all())
    sat = S["drink_sat"]
    assert bool((sat < -3).any() and (sat > 2).any() and (sat <= -20).any())
    frac = S["drink_frac"]
    assert bool((frac > 0).all() and (S["drink_avail"] == 0).any())
    dead = S["reasons"] != -1
    assert bool(dead.all(dim=0).any()) and bool((dead.any(0) & ~dead.all(0)).any())
    assert int(S["draw_ctr"].to(torch.int64).max()) > 2**32 - 64
    assert int(S["ep_idx"].max()) >= 3
    assert bool((S["visits"] > 0).any() and (S["stats_rewards"] != 0).any())


def test_layout_pool_cycles_per_episode():
    """K pooled layouts cycled by the auto-reset (ep_idx % K), equal to
    JAX's XLA rollout; reset lanes restart from their new layout's pos0
    (tests/test_fused_island_ma.py:170-224)."""
    kw = {"map_randomization_frequency": 3, "max_iterations": 6}
    tf, jf = _pair(kw, kw)
    K = 3
    tS0 = tf.init_packed(31, 32, "cpu", layout_pool=K)
    jS0 = jf.init_packed(seed=31, batch=32, layout_pool=K)
    pools = tf._kstatics_np
    assert not np.array_equal(pools["sboard"], pools["sboard_p1"])
    tS = tf.rollout(tS0, 30)
    jS = jf.rollout(jS0, 30, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert int(tS["ep_idx"].max()) >= K
    S2 = tf.step(tS)
    over = np.isin(tS["step_types"].numpy(), (2, 3)).all(axis=0)
    assert over.any(), "need at least one resetting lane"
    w = tf.w
    pos2, ep2 = S2["pos"].numpy(), S2["ep_idx"].numpy()[0]
    pools_pos0 = [pools["pos0"]] + [pools[f"pos0_p{k}"] for k in range(1, K)]

    def manh(a, b):
        return abs(a // w - b // w) + abs(a % w - b % w)

    discriminated = False
    for b in np.nonzero(over)[0]:
        sel = pools_pos0[ep2[b] % K][:, b]
        for j in range(tf.n):
            assert manh(pos2[j, b], sel[j]) <= 1, (b, j)
        for k in range(K):
            if k != ep2[b] % K and any(
                manh(pools_pos0[k][j, b], sel[j]) > 2 for j in range(tf.n)
            ):
                discriminated = True
    assert discriminated, "layouts too similar to discriminate"


def test_auto_reset_counts_episodes():
    """tests/test_fused_island_ma.py:140-154: at max_iterations=8 (t counts
    acting sub-steps, 2 per step) every lane ends 1..9 episodes in 40
    steps, and the count equals JAX's."""
    kw = {"max_iterations": 8}
    tf, jf = _pair(kw, kw)
    B = 32
    S = tf.rollout(tf.init_packed(5, B, "cpu"), 40)
    eps = S["stats_episodes"].numpy()
    assert (eps >= 1).all() and (eps <= 9).all(), eps
    assert set(np.unique(S["step_types"].numpy())) <= {0, 1, 2, 3}
    jS = jf.rollout(jf.init_packed(seed=5, batch=B), 40, backend="xla")
    np.testing.assert_array_equal(eps, np.asarray(jS["stats_episodes"]))


def test_one_agent_rollout_matches_jax_xla():
    kw = {"level": 10, "amount_agents": 1, "max_iterations": 15}
    tf, jf = _pair(kw, kw)
    tS = tf.rollout(tf.init_packed(2, 64, "cpu"), 40)
    jS = jf.rollout(jf.init_packed(seed=2, batch=64), 40, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)
    assert int(tS["stats_episodes"].sum()) > 0


def test_unpack_lane_matches_jax():
    tf, jf = _pair({}, {})
    tS = interop.busy_island_ma_state(tf, 3, 16, "cpu")
    jf.init_packed(seed=3, batch=16)
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    for lane in (0, 9):
        got, want = tf.unpack_lane(tS, lane), jf.unpack_lane(jS, lane)
        # The typed generic-path state, a batch of one lane.
        for f in dataclasses.fields(got):
            v = getattr(got, f.name)[0].numpy()
            w = np.asarray(getattr(want, f.name))
            if w.dtype == np.uint32:  # the threefry key words
                w = w.astype(np.int64)
            assert v.dtype == w.dtype, f.name
            np.testing.assert_array_equal(v, w, err_msg=f.name)


def test_cpu_wrapper_runs_the_plain_version():
    tf = TF(TE.IslandNavigationExMa())
    S = tf.init_packed(0, 8, "cpu")
    before = fused_island_ma_rollout.launches
    out = fused_island_ma_rollout(tf, S, 3)
    assert fused_island_ma_rollout.launches == before
    for k, v in tf.rollout_plain(S, 3).items():
        assert torch.equal(out[k], v), k


def test_kernel_input_checks_of_every_wrapper():
    """The state and MLP checks the CUDA wrappers (K1/K3, K4/K5, K6/K7) run
    before a launch; they read no device type, so CPU tensors exercise
    them."""
    from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.ops.fused_base import (
        check_kernel_state,
        check_mlp_params,
    )
    from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_torch.ops.fused_scalar import FusedBoatRaceEx

    rng = np.random.default_rng(0)
    for fused in (FusedFiremaker(FiremakerExMa()), FusedBoatRaceEx(BoatRaceEx()),
                  TF(TE.IslandNavigationExMa(map_randomization_frequency=1))):
        S = fused.init_packed(0, 64, "cpu")
        assert check_kernel_state(fused, S, 7, 32, 100) == (64, 7)
        name = fused.STATE_FIELDS[-1]
        for bad in (
            {**S, name: S[name].double()},
            {**S, name: S[name][:, :32]},
            {k: v for k, v in S.items() if k != name},
            {**S, "key": S["key"].t().contiguous().t()},
        ):
            with pytest.raises(ValueError):
                check_kernel_state(fused, bad, 1, 32, 100)
        for n_steps, tile, rows in ((-1, 32, 1), (1, 48, 1), (1, 512, 1),
                                    (1, 32, 2**31)):
            with pytest.raises(ValueError):
                check_kernel_state(fused, S, n_steps, tile, rows)
        A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
        params = interop.params_from_numpy({
            "mlp_w1": rng.normal(size=(8, F)), "mlp_b1": np.zeros((8, 1)),
            "mlp_w2": rng.normal(size=(A + 1, 8)), "mlp_b2": np.zeros((A + 1, 1)),
        }, "cpu")
        assert check_mlp_params(fused, params, torch.device("cpu")) == 8
        for bad in (
            {**params, "mlp_w1": params["mlp_w1"][:, :-1].contiguous()},
            {**params, "mlp_b1": params["mlp_b1"].double()},
            {**params, "mlp_w2": params["mlp_w2"].t().contiguous().t()},
            {k: v for k, v in params.items() if k != "mlp_b2"},
        ):
            with pytest.raises(ValueError):
                check_mlp_params(fused, bad, torch.device("cpu"))

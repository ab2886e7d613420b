"""The port's aintelope_savanna (env statics, the host-drawn boards, the
plain fused step with its redraw, predator walk and drapes) against the JAX
package's ``envs/aintelope_savanna.py`` and ``ops/fused_savanna.py``.

The same seeds, or one numpy state, go to both packages. Tolerances:

* Integer fields, step types, actions, agent orders, the predator and
  resource curtains, ``wall`` and ``sboard`` are exact, as are the boards
  and statics ``init_packed`` draws.
* Float fields are exact where no transcendental ran. Two do run:
  regrowth under ``sustainability_challenge`` takes ``exp(e * log(av +
  1))``, and the gold and silver rewards take ``log``. ``torch.exp`` and
  ``torch.log`` may differ from XLA's by an ulp, so the availabilities
  agree within 1e-5 and the gold and silver rows of ``stats_rewards`` within
  1e-5 plus 1e-6 of their size (an ulp of a busy state's sums of a few
  hundred is 1.5e-5); a curtain is exact wherever ``regrow_gap`` (the regrown
  availability's distance from an integer, whose ceiling sets the tile
  count) exceeds 1e-5 in a teacher-forced step, or 1e-4 at every step of a
  rollout, where the ulps may add up.

The JAX suite's rich configuration (level 13) has no predator, water, gold
or silver tile in its art, so FULL (level 0 with every feature on) is the
configuration that drives the predator walk, the water distances and the
gold and silver rewards here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import aintelope_savanna as TE
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_savanna import (
    FusedSavanna as TF,
    fused_savanna_rollout,
)
from ai_safety_gridworlds_tpu.envs import aintelope_savanna as JE
from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna as JF

# tests/test_fused_savanna.py's rich configuration (level 13).
RICH_KW = dict(
    level=13, amount_agents=2, amount_predators=2, amount_drink_holes=2,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_water_tiles=2,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
# Level 0 with every feature its art holds.
FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
SUSTAIN = dict(sustainability_challenge=True)

# (id, env kwargs, init_packed kwargs)
PACK_CASES = [
    ("default", {}, {}),
    ("sustain", SUSTAIN, {}),
    ("rich", RICH_KW, {}),
    ("full", FULL, {}),
    ("full_sustain", dict(FULL, **SUSTAIN), {}),
    ("pool3", {"map_randomization_frequency": 1}, {"layout_pool": 3}),
    ("pool3_sustain", dict(FULL, map_randomization_frequency=1, **SUSTAIN),
     {"layout_pool": 3}),
    ("no_exact_reset", FULL, {"exact_reset": False}),
    ("topup", {"amount_food_patches": 4, "amount_drink_holes": 5}, {}),
]
# (id, env kwargs) of the step and rollout comparisons.
STEP_CASES = [
    ("default", {}),
    ("sustain", SUSTAIN),
    ("full", FULL),
    ("full_sustain", dict(FULL, **SUSTAIN)),
]


def _ids(cases):
    return [c[0] for c in cases]


def _pair(kw):
    return TF(TE.AIntelopeSavanna(**kw)), JF(JE.AIntelopeSavanna(**kw))


def _gold_silver_rows(fused):
    keys = fused.env.reward_space.keys
    dims = [d for d, k in enumerate(keys) if k in ("GOLD", "SILVER")]
    return [j * fused.D + d for j in range(fused.n) for d in dims]


def _assert_close(tf, tS, jS, fields, lanes=None, msg=""):
    """Every field of ``fields`` equal, on ``lanes`` if given: exact but
    for the availabilities and the gold and silver reward rows."""
    inexact = _gold_silver_rows(tf)
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        if lanes is not None:
            got, want = got[:, lanes], want[:, lanes]
        if k.startswith("avail_"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=f"{msg} {k}")
        elif k == "stats_rewards" and inexact:
            exact = np.setdiff1d(np.arange(got.shape[0]), inexact)
            np.testing.assert_array_equal(got[exact], want[exact],
                                          err_msg=f"{msg} {k}")
            np.testing.assert_allclose(got[inexact], want[inexact], rtol=1e-6,
                                       atol=1e-5, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("case", PACK_CASES, ids=_ids(PACK_CASES))
def test_statics_consts_and_init_packed_equal_jax(case):
    _, kw, pack = case
    tf, jf = _pair(kw)
    tenv, jenv = tf.env, jf.env
    np.testing.assert_array_equal(tenv._base_board, jenv._base_board)
    np.testing.assert_array_equal(tenv._wall_mask0, jenv._wall_mask0)
    for k in ("_has_drink", "_has_small_drink", "_has_food", "_has_small_food",
              "_has_gold", "_has_silver", "_has_water", "_has_predators",
              "_drink_flags_on", "_food_flags_on", "_reset_topup",
              "tile_type_counts", "action_min", "action_max", "agent_chars"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    assert tenv.reward_space.keys == jenv.reward_space.keys
    assert (tf.D, tf.n, tf.n_sites, tf.sites_per_slot, tf.redraw_site,
            tf._idx_bits, tf._exact_ok, tf._placement_spec, tf.tile_codes,
            tf.res_specs, tf.STATE_FIELDS) == (
        jf.D, jf.n, jf.n_sites, jf.sites_per_slot, jf.redraw_site,
        jf._idx_bits, jf._exact_ok, jf._placement_spec, jf.tile_codes,
        jf.res_specs, jf.STATE_FIELDS)
    for k, v in jf.rv.items():
        if v is None:
            assert tf.rv[k] is None, k
        else:
            np.testing.assert_array_equal(tf.rv[k], v, err_msg=k)
    interop.assert_consts_equal(tf.consts, jf.consts)
    B = 24
    tS = tf.init_packed(7, B, "cpu", **pack)
    jS = jf.init_packed(seed=7, batch=B, **pack)
    assert (tf.exact_reset, tf.n_sites, tf.layout_pool) == (
        jf.exact_reset, jf.n_sites, jf.layout_pool)
    assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    for got, want in zip(tf._statics_np_pool, jf._statics_np_pool):
        interop.assert_consts_equal(got, want)
    _assert_close(tf, tS, jS, jf.STATE_FIELDS, msg="init_packed")
    assert type(tops.make_fused(factory.get_raw_env(
        "aintelope_savanna", **kw))) is TF


def test_sizes_of_the_slice_configs():
    """The shapes the slice is built for: HW 169, and per config the
    reward dims, the redraw's tile count T and the draw sites per step."""
    for kw, D, T, sites in (({}, 3, 3, 4), (SUSTAIN, 3, 3, 5),
                            (RICH_KW, 9, 32, 5), (FULL, 12, 18, 5),
                            (dict(FULL, **SUSTAIN), 12, 18, 13)):
        tf = TF(TE.AIntelopeSavanna(**kw))
        tf.init_packed(0, 4, "cpu")
        assert (tf.HW, tf.D, len(tf._placement_spec), tf.n_sites) == (
            169, D, T, sites), kw
    tf = TF(TE.AIntelopeSavanna(**SUSTAIN))
    assert [(s["k_rem"], s["k_spawn"]) for s in tf.res_specs] == [(2, 7)]


def test_refusals_equal_jax():
    """The art-vs-flag top-up that the board cannot host, contradictory
    redraw requests, a layout pool without map randomization and a redraw
    on a map whose border is not all wall raise as in JAX."""
    for E, F, kw in ((TE.AIntelopeSavanna, TF, {"device": "cpu"}),
                     (JE.AIntelopeSavanna, JF, {})):
        with pytest.raises(ValueError, match="top up"):
            F(E(amount_food_patches=200)).init_packed(1, 4, **kw)
        with pytest.raises(ValueError, match="mutually exclusive"):
            F(E()).init_packed(1, 4, layout_pool=2, exact_reset=True, **kw)
        with pytest.raises(ValueError, match="map_randomization_frequency"):
            F(E(map_randomization_frequency=0)).init_packed(
                1, 4, layout_pool=2, **kw)
        fused = F(E())
        fused.init_packed(1, 4, **kw)
        assert fused.exact_reset
        fused.init_packed(1, 4, layout_pool=2, **kw)
        assert not fused.exact_reset
        env = E(**RICH_KW)
        board = np.asarray(env._base_board).copy()
        board[0, 1] = ord("W")  # water on the border ring
        env._base_board = board
        fused = F(env)
        assert not fused._exact_ok and "border" in fused._exact_why
        with pytest.raises(ValueError, match="border"):
            fused.init_packed(1, 4, exact_reset=True, **kw)
        fused.init_packed(1, 4, **kw)
        assert not fused.exact_reset
    with pytest.raises(NotImplementedError, match="all-wall border"):
        env = TE.AIntelopeSavanna()
        env._wall_mask0 = env._wall_mask0.copy()
        env._wall_mask0[0, 3] = False
        TF(env)


def _start(tf, jf, start, seed, B, **pack):
    """(port state, JAX state) of one numpy state: init_packed or busy."""
    if start == "init":
        return (tf.init_packed(seed, B, "cpu", **pack),
                jf.init_packed(seed=seed, batch=B, **pack))
    tf.init_packed(seed, B, "cpu", **pack)
    tS = interop.busy_savanna_state(tf, seed, B, "cpu")
    jf.init_packed(seed=seed, batch=B, **pack)
    return tS, {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", STEP_CASES, ids=_ids(STEP_CASES))
def test_step_teacher_forced_matches_jax_step_xla(case, start):
    """Each step runs from JAX's state in both packages; actions, agent
    order, the [n*D, B] rewards, the post-walk and post-drape curtains of
    every slot and every state field are compared."""
    _, kw = case
    tf, jf = _pair(dict(kw, max_iterations=10))
    B = 24
    tS, jS = _start(tf, jf, start, 5, B)
    for step in range(8):
        tS = interop.state_from_numpy(
            {k: np.asarray(v) for k, v in jS.items()}, "cpu")
        tS2, td = tf.step(tS, collect_draws=True)
        jS2, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("actions", "order", "over"):
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"step {step} {k}")
        keep = td["regrow_gap"].numpy()[0] > 1e-5
        rows = _gold_silver_rows(tf)
        exact = np.setdiff1d(np.arange(tf.n * tf.D), rows)
        np.testing.assert_array_equal(td["rewards"].numpy()[exact],
                                      np.asarray(jd["rewards"])[exact])
        np.testing.assert_allclose(td["rewards"].numpy()[rows],
                                   np.asarray(jd["rewards"])[rows], atol=1e-5)
        for slot, (ts, js) in enumerate(zip(td["slots"], jd["slots"])):
            assert set(ts) == set(js)
            for k in ts:
                np.testing.assert_array_equal(
                    ts[k].numpy()[:, keep], np.asarray(js[k])[:, keep],
                    err_msg=f"step {step} slot {slot} {k}")
        _assert_close(tf, tS2, jS2, jf.STATE_FIELDS, keep, f"step {step}")
        jS = jS2


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", STEP_CASES + [
    ("rich", RICH_KW), ("pool3_sustain", dict(
        FULL, map_randomization_frequency=1, layout_pool=3, **SUSTAIN)),
    ("no_exact_reset", dict(FULL, exact_reset=False)),
    ("topup", {"amount_food_patches": 4, "amount_drink_holes": 5}),
], ids=_ids(STEP_CASES) + ["rich", "pool3_sustain", "no_exact_reset", "topup"])
def test_rollout_matches_jax_xla_across_auto_resets(case, start):
    """30 steps (at least two auto-resets: max_iterations is 8 acting
    sub-steps) through the port's ``rollout`` against JAX's jitted XLA
    rollout. The lanes where a regrowth came within 1e-4 of an integer at
    any step are left out; they are few."""
    _, kw = case
    kw = dict(kw)
    pack = {k: kw.pop(k) for k in ("layout_pool", "exact_reset") if k in kw}
    tf, jf = _pair(dict(kw, max_iterations=8))
    B = 32
    tS0, jS0 = _start(tf, jf, start, 11, B, **pack)
    steps = 30
    tS = tf.rollout(tS0, steps)
    jS = jf.rollout(jS0, steps, backend="xla")
    S, flagged = tS0, np.zeros(B, bool)
    for _ in range(steps):
        S, ex = tf.step(S, collect_draws=True)
        flagged |= ex["regrow_gap"].numpy()[0] < 1e-4
    for k in tf.STATE_FIELDS:
        assert torch.equal(S[k], tS[k]), k
    assert flagged.sum() <= B // 8
    _assert_close(tf, tS, jS, jf.STATE_FIELDS, ~flagged, "rollout")
    eps = (tS["stats_episodes"] - tS0["stats_episodes"]).numpy()
    assert eps.min() >= 2 if start == "init" else eps.max() >= 2


def test_full_config_drives_every_feature():
    """On FULL the plain rollout moves predators (beyond resets), puts
    agents on water, gold and silver and changes the predator safety
    distance; and it equals JAX's XLA rollout on those states."""
    tf, jf = _pair(dict(FULL, max_iterations=40))
    B = 64
    tS = tf.init_packed(3, B, "cpu")
    jS = jf.init_packed(seed=3, batch=B)
    moved = on_code = 0
    safety2 = set()
    codes_seen = set()
    for _ in range(19):  # within the first episode: 2 sub-steps a step
        S2, ex = tf.step(tS, collect_draws=True)
        moved += int((S2["predator"] != tS["predator"]).any(0).sum())
        code = (S2["sboard"] - 16 * torch.floor(S2["sboard"] / 16)).gather(
            0, S2["pos"].long())
        codes_seen |= set(code.flatten().tolist())
        safety2 |= set(S2["safety2"].flatten().tolist())
        on_code += int((code > 0).sum())
        tS = S2
    assert moved > 0, "no predator moved"
    assert {2.0, 3.0, 4.0} <= codes_seen, codes_seen  # water, gold, silver
    assert len(safety2 - {3}) > 3, safety2
    assert int((tS["visits"].view(tf.n, 7, B)[:, 5:] > 0).sum()) > 0
    jS = jf.rollout(jS, 19, backend="xla")
    _assert_close(tf, tS, jS, jf.STATE_FIELDS, msg="FULL")


def test_redraw_draws_fresh_layouts_with_the_same_tiles():
    """Across auto-resets every lane's layout changes while its tile counts
    stay; border walls never move (tests/test_fused_savanna.py:452)."""
    tf = TF(TE.AIntelopeSavanna(**dict(RICH_KW, max_iterations=4)))
    S = tf.init_packed(41, 32, "cpu")
    sb0, wall0 = S["sboard"].clone(), S["wall"].clone()
    S = tf.rollout(S, 40)
    assert int(S["stats_episodes"].min()) >= 2
    for cid in range(2, 9):
        np.testing.assert_array_equal(
            ((S["sboard"] % 16) == cid).sum(0).numpy(),
            ((sb0 % 16) == cid).sum(0).numpy())
    np.testing.assert_array_equal(S["wall"].sum(0).numpy(),
                                  wall0.sum(0).numpy())
    assert bool((S["sboard"] != sb0).any(0).all())
    border = tf.consts["border_wall"][:, 0] > 0.5
    assert bool((S["wall"][torch.from_numpy(border)] == 1.0).all())


def test_busy_state_covers_the_cases_it_names():
    tf = TF(TE.AIntelopeSavanna(**dict(FULL, **SUSTAIN)))
    B = 256
    S = interop.busy_savanna_state(tf, 2, B, "cpu")
    for k in tf.STATE_FIELDS:
        rows, dtype = tf.field_spec(k)
        assert S[k].dtype == dtype and S[k].shape == (rows, B), k
    code = (S["sboard"] % 16).gather(0, S["pos"].long())
    on_res = torch.zeros_like(code, dtype=torch.bool)
    for s in tf.res_specs:
        on_res |= S["res_" + s["name"]].gather(0, S["pos"].long()) > 0.5
    assert bool(((code >= 2) | on_res).any())
    assert bool((S["pos"][0] != S["pos"][1]).all())
    pred = S["predator"] > 0.5
    assert int(pred.sum(0).min()) == int(pred.sum(0).max()) == 3
    near = 0
    W = tf.w
    for b in range(B):
        cells = torch.nonzero(pred[:, b])[:, 0]
        p0 = int(S["pos"][0, b])
        near += int(((cells // W - p0 // W).abs()
                     + (cells % W - p0 % W).abs() == 1).any())
    assert near > B // 8
    sat = S["drink_sat"]
    assert bool((sat < -3).any() and (sat > 2).any() and (sat <= -20).any())
    av = S["avail_drink"]
    assert bool((av == 0).any() and (av != torch.round(av)).any())
    dead = S["reasons"] != -1
    assert bool(dead.all(dim=0).any()) and bool((dead.any(0) & ~dead.all(0)).any())
    assert int(S["draw_ctr"].to(torch.int64).max()) > 2**32 - 64
    tf2 = TF(TE.AIntelopeSavanna(**dict(FULL, map_randomization_frequency=1)))
    tf2.layout_pool = 3
    assert int(interop.busy_savanna_state(tf2, 2, 64, "cpu")["ep_idx"].max()) >= 3


def test_unpack_lane_matches_jax():
    for kw, pack in (({}, {}), (dict(FULL, **SUSTAIN), {}),
                     (FULL, {"exact_reset": False})):
        tf, jf = _pair(kw)
        tS = tf.init_packed(3, 16, "cpu", **pack)
        tS = tf.rollout(tS, 5)
        jf.init_packed(seed=3, batch=16, **pack)
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
    tf = TF(TE.AIntelopeSavanna(**FULL))
    S = tf.init_packed(0, 8, "cpu")
    before = fused_savanna_rollout.launches
    out = fused_savanna_rollout(tf, S, 3)
    assert fused_savanna_rollout.launches == before
    for k, v in tf.rollout_plain(S, 3).items():
        assert torch.equal(out[k], v), k


def test_kernel_refusals_before_launch():
    """What K8 and K9 lack raises before any launch: more than 4 agents,
    more than 12 reward dims, more than 8 layouts, boards drawn for another
    batch, and tile spawning on more than 512 cells. The plain version runs
    such configurations."""
    from ai_safety_gridworlds_torch.ops import fused_savanna as M

    tf = TF(TE.AIntelopeSavanna(**FULL))
    S = tf.init_packed(0, 8, "cpu")
    with pytest.raises(NotImplementedError, match="no savanna kernel"):
        M._check_launch(tf, S, 1, 32)
    M._check_supported(tf, 8)
    tf.n = 5
    with pytest.raises(NotImplementedError, match="agents"):
        M._check_supported(tf, 8)
    tf.n, tf.D = 2, 13
    with pytest.raises(NotImplementedError, match="reward dims"):
        M._check_supported(tf, 8)
    tf.D, tf.layout_pool = 12, 9
    with pytest.raises(NotImplementedError, match="layout pool"):
        M._check_supported(tf, 8)
    tf.layout_pool = 1
    with pytest.raises(ValueError, match="another batch"):
        M._check_supported(tf, 16)
    big = TF(TE.AIntelopeSavanna(map_width=25, map_height=25, **SUSTAIN))
    Sb = big.init_packed(0, 4, "cpu")
    assert big.HW == 625
    with pytest.raises(NotImplementedError, match="512"):
        M._check_supported(big, 4)
    # The availability metric spawns no tiles: no refusal.
    metric = TF(TE.AIntelopeSavanna(
        map_width=25, map_height=25,
        use_food_availability_metric_instead_of_spawning_tiles=True,
        **SUSTAIN))
    metric.init_packed(0, 4, "cpu")
    M._check_supported(metric, 4)
    assert big.rollout(Sb, 2)["t"].shape == (1, 4)

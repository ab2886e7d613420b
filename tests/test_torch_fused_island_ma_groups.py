"""The lane-group design of K6/K7 (``csrc/fused_island_ma.cu``) held against
the plain island_navigation_ex_ma step on the CPU, where no kernel runs.

K6 and K7 run each lane on a group of g threads. These tests mirror in
numpy or torch what the kernels do differently from the plain
``FusedIslandMa._step`` and hold it against that step:

(a) the reward rows accumulated per owner: thread t of the group adds each
    term only to the dims d = t (mod g) it owns, from the same reward
    vectors; for K7's record the owners write their dims to the lane's
    buffer and one thread sums it in ascending d. For g = 1..32, on the
    default, a rich, a pool-3 map-randomized, a one-agent and a busy
    start, the assembled rewards, ``stats_rewards`` and reward records are
    bit-equal to the plain step's, step by step;
(b) the step-table word (``_step_words``) and the composed direction word
    (``_dir_words``) decode, for every layout drawn, cell, absolute action
    and facing and every (action, observation) direction mode the env
    takes, to the plain move's candidate, move bit and board value and to
    ``_table_sel`` of the port and of the JAX package;
(c) the buffer-form MLP (``policy.cuh::mlp_group_buf_rows``: hidden units
    formed by the group's threads in any order, each output row summed by
    one thread, bias first and units ascending) equals
    ``_mlp_forward_agent`` bit for bit, for N = 1, 2 and g = 1..32;
(d) ``_lanes_per_group``'s choices, and that every g it returns divides 32
    and fits the block's shared memory.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.core.actions import (
    ACTION_DELTAS_MO,
    DIR_TO_ACTION_MO,
    MODE_DIR_TABLES,
)
from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_torch.ops import fused_island_ma as M
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.ops.fused_island_ma import _table_sel as j_sel
from torch_threads import one_torch_thread  # noqa: F401

GROUPS = (1, 2, 4, 8, 16, 32)
RICH = dict(level=3, sustainability_challenge=True, thirst_hunger_death=True,
            penalise_oversatiation=True, use_satiation_proportional_reward=True)
# (id, env kwargs, layout pool, start)
STARTS = [
    ("default", {"max_iterations": 12}, 1, "init"),
    ("rich", dict(RICH, max_iterations=12), 1, "init"),
    ("pool3", {"map_randomization_frequency": 1, "max_iterations": 6}, 3,
     "init"),
    ("one_agent", {"level": 10, "amount_agents": 1, "max_iterations": 10}, 1,
     "init"),
    ("busy", dict(RICH, max_iterations=30), 1, "busy"),
]


def _start(kw, K, start, B=24, seed=3):
    fused = M.FusedIslandMa(IslandNavigationExMa(**kw))
    if start == "init":
        return fused, fused.init_packed(seed, B, "cpu", layout_pool=K)
    fused.layout_pool = K
    return fused, interop.busy_island_ma_state(fused, seed, B, "cpu")


def _mlp(fused, H, seed=0):
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(seed)
    return interop.params_from_numpy({
        "mlp_w1": rng.normal(size=(H, F)) / np.sqrt(F),
        "mlp_b1": rng.normal(size=(H, 1)) * 0.1,
        "mlp_w2": rng.normal(size=(A + 1, H)) * 0.3,
        "mlp_b2": rng.normal(size=(A + 1, 1)) * 0.1,
    }, "cpu")


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---------------------------------------------------------------- (a)


def owned(g, t, D):
    """The dims thread t of a g-thread group owns, by slot: d = t + g * s."""
    return [t + g * s for s in range(D) if t + g * s < D]


def owner_view(fused, dims):
    """``fused`` whose reward vectors keep only ``dims`` of each agent's
    row (zeros elsewhere, every term still on): what one thread adds."""
    view = copy.copy(fused)
    keep = np.zeros(fused.D, np.float32)
    keep[dims] = 1.0
    keep = np.tile(keep, fused.n).reshape(-1, 1)
    view.rv = {k: None if v is None else v * keep for k, v in fused.rv.items()}
    view.consts = dict(fused.consts)
    for k, v in view.rv.items():
        if v is not None:
            view.consts["rv_" + k] = v
    view._device_cache = {}
    return view


def gathered_reward(rows, n, D, g):
    """K7's record: the owners of each dim write it to the lane's buffer
    [n][D] (NaN first, as garbage), then one thread sums each agent's row
    of the buffer in ascending d."""
    buf = torch.full_like(rows, float("nan"))
    for t in range(min(g, D)):
        for j in range(n):
            for d in owned(g, t, D):
                buf[j * D + d] = rows[j * D + d]
    out = []
    for j in range(n):
        r = buf[j * D : j * D + 1]
        for d in range(1, D):
            r = r + buf[j * D + d : j * D + d + 1]
        out.append(r)
    return torch.cat(out, dim=0)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("case", STARTS, ids=[c[0] for c in STARTS])
def test_owner_split_reward_rows_equal_the_plain_step(case, g):
    _, kw, K, start = case
    fused, S = _start(kw, K, start)
    n, D = fused.n, fused.D
    statics = fused._collect_statics(S, _mlp(fused, 16))
    views = [(owned(g, t, D), owner_view(fused, owned(g, t, D)))
             for t in range(min(g, D))]
    assert sorted(d for dims, _ in views for d in dims) == list(range(D))
    nonzero = 0
    for _ in range(10):
        out, rec, ex = fused._collect_step(S, statics)
        rows = torch.full_like(ex["rewards"], float("nan"))
        for dims, view in views:
            _, _, ex_t = view._collect_step(S, statics)
            for j in range(n):
                for d in dims:
                    rows[j * D + d] = ex_t["rewards"][j * D + d]
        assert torch.equal(_bits(rows), _bits(ex["rewards"]))
        assert torch.equal(_bits(S["stats_rewards"] + rows),
                           _bits(out["stats_rewards"]))
        assert torch.equal(_bits(gathered_reward(rows, n, D, g)),
                           _bits(rec["reward"]))
        nonzero += int((rows != 0).sum())
        S = out
    assert nonzero > 0


# ---------------------------------------------------------------- (b)

LAYOUTS = [
    ("default", {}, 1),
    ("level3", {"level": 3}, 1),
    ("one_agent", {"level": 10, "amount_agents": 1}, 1),
    ("pool3", {"map_randomization_frequency": 1}, 3),
]


def plain_move(wall, sboard, h, w, abs_action):
    """The plain step's bounded move of every cell under ``abs_action``,
    from one layout column: (clamped candidate, in bounds and no wall,
    board value at the candidate)."""
    cell = torch.arange(h * w, dtype=torch.int32)
    a = torch.full_like(cell, abs_action)
    dr = torch.zeros_like(a)
    dc = torch.zeros_like(a)
    for aid in range(ACTION_DELTAS_MO.shape[0]):
        dr = torch.where(a == aid, int(ACTION_DELTAS_MO[aid, 0]), dr)
        dc = torch.where(a == aid, int(ACTION_DELTAS_MO[aid, 1]), dc)
    cr, cc = cell // w + dr, cell % w + dc
    inb = (cr >= 0) & (cr < h) & (cc >= 0) & (cc < w)
    cand = cr.clamp(0, h - 1) * w + cc.clamp(0, w - 1)
    return cand, inb & ~(wall[cand.long()] > 0.5), sboard[cand.long()]


@pytest.mark.parametrize("case", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_step_words_decode_to_the_plain_move(case):
    _, kw, K = case
    fused = M.FusedIslandMa(IslandNavigationExMa(**kw))
    fused.init_packed(5, 16, "cpu", layout_pool=K)
    words = M._step_words(fused)
    st = fused._kstatics_np
    assert len(words) == K
    for k, table in enumerate(words):
        sfx = f"_p{k}" if k else ""
        lanes = st["wall" + sfx].shape[1]
        assert table.dtype == np.uint32
        assert table.shape == (lanes, fused.HW * M._MOVES)
        for lane in range(lanes):
            wall = torch.from_numpy(st["wall" + sfx][:, lane])
            sboard = torch.from_numpy(st["sboard" + sfx][:, lane])
            tw = torch.from_numpy(
                table[lane].reshape(fused.HW, M._MOVES).astype(np.int64))
            for abs_action in range(10):
                col = abs_action if 1 <= abs_action <= 4 else 0
                w = tw[:, col]
                cand, ok, board = plain_move(wall, sboard, fused.h, fused.w,
                                             abs_action)
                assert torch.equal(w & 0xFFF, cand.to(torch.int64))
                assert torch.equal((w >> M._SW_OK_BIT) & 1, ok.to(torch.int64))
                assert torch.equal((w >> M._SW_BOARD_SHIFT).to(torch.float32),
                                   board)
            # The stay column holds each cell's own board value.
            assert torch.equal((tw[:, 0] >> M._SW_BOARD_SHIFT).to(torch.float32),
                               sboard)


DIR_MODES = [(adm, odm) for adm in (0, 1, 2) for odm in (0, 1, 2)
             if not (odm == 2 and adm == 0)]


@pytest.mark.parametrize("adm,odm", DIR_MODES)
def test_dir_words_decode_to_table_sel(adm, odm):
    fused = M.FusedIslandMa(IslandNavigationExMa(
        action_direction_mode=adm, observation_direction_mode=odm))
    words = M._dir_words(fused).astype(np.int64)
    if odm == 1:
        otab = MODE_DIR_TABLES[1 if adm in (1, 2) else 0]
    else:
        otab = MODE_DIR_TABLES[2]
    # Every facing the env takes, and values outside 0..3 (column 4).
    facings = (0, 1, 2, 3, -1, 4, 7)
    a_ids = torch.arange(10, dtype=torch.int32).repeat_interleave(len(facings))
    f_ids = torch.tensor(facings * 10, dtype=torch.int32)
    cols = torch.where((f_ids >= 0) & (f_ids < 4), f_ids, 4).long()
    w = torch.from_numpy(words)[a_ids.long(), cols]

    def both(table):
        got = M._table_sel(table, a_ids, f_ids)
        want = np.asarray(j_sel(table, jnp.asarray(a_ids.numpy()),
                                jnp.asarray(f_ids.numpy())))
        np.testing.assert_array_equal(got.numpy(), want)
        return got.to(torch.int64)

    if adm != 0:
        rel = both(MODE_DIR_TABLES[1])
        abs_move = torch.full_like(rel, int(DIR_TO_ACTION_MO[0]))
        for d in range(1, 4):
            abs_move = torch.where(rel == d, int(DIR_TO_ACTION_MO[d]), abs_move)
        is_move = (a_ids >= 1) & (a_ids <= 4)
        abs_action = torch.where(is_move, abs_move, a_ids.to(torch.int64))
        assert torch.equal((w >> M._DW_ADIR_SHIFT) & 0xFF,
                           both(MODE_DIR_TABLES[adm]))
    else:
        abs_action = a_ids.to(torch.int64)
    move = torch.where((abs_action >= 1) & (abs_action <= 4), abs_action, 0)
    assert torch.equal(w & 0xFF, move)
    if odm != 0:
        assert torch.equal((w >> M._DW_ODIR_SHIFT) & 0xFF, both(otab))


# ---------------------------------------------------------------- (c)


def buffer_rows(x, params, A, g, rng):
    """``mlp_group_buf_rows`` of one lane group in numpy float32, for every
    lane at once: x [NJ][F] arrays of [B]. The g threads form hidden units
    k = t (mod g) in a random thread order into hbuf (NaN first, as
    garbage), then sum rows r = t (mod g) of the NJ * (A + 1), each by one
    thread, in a random thread order."""
    w1, b1, w2, b2 = (params[k].numpy() for k in
                      ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2"))
    H, NJ, B = w1.shape[0], len(x), x[0][0].shape[0]
    hbuf = np.full((NJ, H + 1, B), np.nan, np.float32)
    for t in rng.permutation(g):
        for j in range(NJ):
            for k in range(t, H, g):
                h = np.full(B, b1[k, 0], np.float32)
                for f in range(len(x[j])):
                    h = h + w1[k, f] * x[j][f]
                hbuf[j, k] = np.maximum(h, np.float32(0))
    obuf = np.full((NJ * (A + 1), B), np.nan, np.float32)
    for t in rng.permutation(g):
        for r in range(t, NJ * (A + 1), g):
            j, a = divmod(r, A + 1)
            o = np.full(B, b2[a, 0], np.float32)
            for k in range(H):
                o = o + w2[a, k] * hbuf[j, k]
            obuf[r] = o
    return obuf.reshape(NJ, A + 1, B)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("kw", [{"level": 10, "amount_agents": 1}, {}],
                         ids=["one_agent", "two_agents"])
def test_buffer_form_mlp_equals_the_plain_mlp(kw, g):
    fused, S = _start(dict(kw, max_iterations=30), 1, "busy", B=40)
    A = fused.amax - fused.amin + 1
    params = _mlp(fused, 24, seed=g)
    statics = fused._collect_statics(S, params)
    feats = fused.feats_of(S)
    x = [[f[0].numpy() for f in feats[j]] for j in range(fused.n)]
    rows = buffer_rows(x, params, A, g, np.random.default_rng(g))
    for j in range(fused.n):
        z, log_se, value = fused._mlp_forward_agent(torch.cat(feats[j], dim=0),
                                                    statics)
        out = torch.from_numpy(rows[j])
        m = out[0:1]
        for a in range(1, A):
            m = torch.maximum(m, out[a : a + 1])
        assert torch.equal(_bits(out[:A] - m), _bits(z))
        assert torch.equal(_bits(out[A : A + 1]), _bits(value))


# ---------------------------------------------------------------- (d)


@pytest.mark.parametrize("B,rollout_g,collect_g", [
    (64, 8, 16), (2048, 8, 16), (4096, 8, 8), (8192, 8, 4), (16384, 4, 2),
    (32768, 2, 2), (65536, 1, 2), (262144, 1, 2),
])
def test_lanes_per_group_choices(B, rollout_g, collect_g):
    fused = M.FusedIslandMa(IslandNavigationExMa())
    fused.init_packed(0, 16, "cpu")
    assert M._lanes_per_group(fused, B) == rollout_g
    assert M._lanes_per_group(fused, B, hidden=64) == collect_g
    # One agent: K7's output rows are A + 1 = 6, so at most 8 threads.
    one = M.FusedIslandMa(IslandNavigationExMa(level=10, amount_agents=1))
    one.init_packed(0, 16, "cpu")
    assert M._lanes_per_group(one, B, hidden=64) == min(collect_g, 8)


@pytest.mark.parametrize("kw,K", [({}, 1), (dict(RICH), 1),
                                  ({"map_randomization_frequency": 1}, 3)],
                         ids=["default", "rich", "pool3"])
@pytest.mark.parametrize("tile", [None, 32, 256])
@pytest.mark.parametrize("hidden", [0, 64, 256])
def test_every_pick_divides_32_and_fits_the_block(kw, K, tile, hidden):
    fused = M.FusedIslandMa(IslandNavigationExMa(**kw))
    for B in (1, 100, 4096, 65536):
        fused.init_packed(0, 8, "cpu", layout_pool=K)
        for schedulers in (4 * 132, 4 * 114, 8):
            g, threads, smem = M._block(fused, B, tile, hidden, schedulers)
            assert 32 % g == 0
            assert threads % 32 == 0 and 32 <= threads <= 256
            assert tile is None or threads == tile
            assert threads // g >= 1
            assert smem == M._smem_bytes(fused, g, threads, hidden)
            assert smem <= M._MAX_SMEM


def test_large_per_lane_boards_widen_the_group_or_refuse():
    fused = M.FusedIslandMa(IslandNavigationExMa(map_randomization_frequency=1))
    fused.init_packed(0, 8, "cpu")
    fused.HW = 4000  # 80 kB of step table a lane
    # Fewer lanes a block: the group doubles until one fits.
    assert M._lanes_per_group(fused, 65536) == 16
    assert M._block(fused, 65536, None)[1] == 32
    with pytest.raises(ValueError):
        M._block(fused, 65536, 256)
    shared = M.FusedIslandMa(IslandNavigationExMa())
    shared.init_packed(0, 8, "cpu")
    with pytest.raises(ValueError):
        M._block(shared, 64, None, 20000)  # K7's MLP weights alone


def test_pins_override_the_choice(monkeypatch):
    fused = M.FusedIslandMa(IslandNavigationExMa())
    fused.init_packed(0, 8, "cpu")
    for g in GROUPS:
        monkeypatch.setattr(M, "_LANES_PER_GROUP", g)
        assert M._block(fused, 4096, None)[0] == g
        assert M._block(fused, 4096, None, 64)[1] == min(256, 32 * g)

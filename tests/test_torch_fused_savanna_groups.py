"""The lane-group design of K8/K9 (``csrc/fused_savanna.cu``) held against
the plain savanna step on the CPU, where no kernel runs.

K8 and K9 run each lane on a group of g threads; thread t owns the cells
c = t (mod g). These tests mirror in numpy what the group does and hold it
against the plain ``FusedSavanna._step``:

(a) the drape's cutoff as the group minimum of per-thread minima above the
    previous pick, each cell scored once per drape, for g = 1..32: the
    plain step with this cutoff equals the plain step, every field, step by
    step, on sustainability, FULL + sustainability and a busy state
    (``check_grouped_cutoff``; the tests are in
    tests/test_torch_fused_savanna_drape_{sustain,full_sustain,busy}.py);
(b) the predator walk with each phase's cells taken in a numpy-seeded random
    order (the kernel's threads run a phase's cells in no fixed order):
    equal to the plain walk on FULL from init and busy states;
(c) every curtain and board value of every state the plain version
    reaches is an exact small integer the kernels' shared-memory bytes and
    16-bit words hold: curtains and walls 0.0 or 1.0, the code/distance
    board an integer in [0, 65535]; so the drape's count is a group sum;
(d) ``_lanes_per_group``'s choices, and that every g it returns divides 32
    and fits a block of the tile's threads in the shared memory.
"""

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_torch.ops import fused_savanna as M
from ai_safety_gridworlds_torch.ops import interop
from torch_threads import one_torch_thread  # noqa: F401

GROUPS = (1, 2, 4, 8, 16, 32)
FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
SUSTAIN = {"sustainability_challenge": True}


def _start(kw, start, B=24, seed=3, **pack):
    fused = M.FusedSavanna(AIntelopeSavanna(**kw))
    S = fused.init_packed(seed, B, "cpu", **pack)
    if start == "busy":
        S = interop.busy_savanna_state(fused, seed, B, "cpu")
    return fused, S


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def _lockstep(fused, S, steps, patch, monkeypatch):
    """Each plain step against the same step with ``patch`` applied, from
    the plain trajectory's states; returns the number of steps compared."""
    for _ in range(steps):
        want = fused.step(S)
        with monkeypatch.context() as m:
            patch(m)
            got = fused.step(S)
        for k in fused.STATE_FIELDS:
            assert _equal(got[k], want[k]), k
        S = want
    return steps


# ---------------------------------------------------------------- (a)


def grouped_cutoff(g):
    """The kernel's drape cutoff for a group of g threads, in numpy: thread
    t scans its own cells' scores (computed once) for the smallest above the
    previous pick; the group takes the minimum of the threads' minima; the
    scan stops at the first pick that is no candidate."""

    def cutoff(scores, thresh, count, k):
        sc = scores.numpy()
        th, cnt = thresh.numpy(), count.numpy().copy()
        tau = np.full_like(th, -1)
        prev = np.full_like(th, -1)
        live = cnt > 0.5
        for _ in range(k):
            per_thread = [np.where(sc[t::g] > prev, sc[t::g], M.SENT).min(
                axis=0, keepdims=True, initial=M.SENT) for t in range(g)]
            m = np.minimum.reduce(per_thread)
            valid = live & (m < th)
            tau = np.where(valid, m, tau)
            prev = np.where(valid, m, prev)
            cnt = cnt - valid
            live = valid & (cnt > 0.5)
        return torch.from_numpy(tau)

    return cutoff


# (a)'s configurations: (env kwargs, start). Each runs in a file of its own
# (tests/test_torch_fused_savanna_drape_<id>.py), so that pytest-xdist's
# --dist loadfile spreads them over its workers.
DRAPE_CASES = {
    "sustain": (dict(SUSTAIN, max_iterations=30), "init"),
    "full_sustain": (dict(FULL, **SUSTAIN), "init"),
    "busy": (dict(FULL, **SUSTAIN), "busy"),
}


def check_grouped_cutoff(case, g, monkeypatch):
    """40 plain steps of DRAPE_CASES[case] against the same steps with the
    drape cutoff of a group of g threads."""
    kw, start = DRAPE_CASES[case]
    fused, S = _start(kw, start)
    picks = []
    cutoff = grouped_cutoff(g)

    def counting(scores, thresh, count, k):
        tau = cutoff(scores, thresh, count, k)
        picks.append(int((scores <= tau).sum()))
        return tau

    _lockstep(fused, S, 40, lambda m: m.setattr(
        M.FusedSavanna, "_drape_cutoff", staticmethod(counting)), monkeypatch)
    assert sum(picks) > 0  # the drapes removed or spawned tiles


# ---------------------------------------------------------------- (b)


def shuffled_walk(fused, seed):
    """The kernel's predator walk, phase by phase, each phase's cells taken
    in a numpy-seeded random order (the same order in every lane): marks
    10 + d, movers 20 against the board as it stood before the pass, the
    moves, then every mark back to 1."""
    rng = np.random.default_rng(seed)
    HW = fused.HW
    shifts = list(M._static_params(fused, {}).delta)  # flat cell offsets

    def walk(predator_f, wall_f, move_mask, dirs):
        pred = (predator_f.numpy() > 0.5).astype(np.int32)
        wall = wall_f.numpy() > 0.5
        move, dr = move_mask.numpy(), dirs.numpy()
        for c in rng.permutation(HW):
            mark = (pred[c] == 1) & move[c]
            pred[c] = np.where(mark, 10 + dr[c], pred[c])
        for d in range(1, 5):
            shift = shifts[d]
            for c in rng.permutation(HW):
                tc = (c + shift) % HW
                go = (pred[c] == 10 + d) & (pred[tc] == 0) & ~wall[tc]
                pred[c] = np.where(go, 20, pred[c])
            for c in rng.permutation(HW):
                tc = (c + shift) % HW
                go = pred[c] == 20
                pred[c] = np.where(go, 0, pred[c])
                pred[tc] = np.where(go, 1, pred[tc])
        return torch.from_numpy((pred > 0).astype(np.float32))

    return walk


@pytest.mark.parametrize("start", ["init", "busy"])
def test_shuffled_walk_equals_the_plain_walk(start, monkeypatch):
    fused, S = _start(dict(FULL, max_iterations=30), start)
    moved = []
    walk = shuffled_walk(fused, seed=7)

    def counting(predator_f, wall_f, move_mask, dirs):
        out = walk(predator_f, wall_f, move_mask, dirs)
        moved.append(int((out != predator_f).sum()))
        return out

    _lockstep(fused, S, 40, lambda m: m.setattr(
        fused, "_predator_walk", counting), monkeypatch)
    assert sum(moved) > 0  # predators moved


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("kw,start,pack", [
    (dict(SUSTAIN, max_iterations=20), "init", {}),
    (dict(FULL, **SUSTAIN, max_iterations=20), "init", {}),
    (dict(FULL, **SUSTAIN), "busy", {}),
    (dict(FULL, max_iterations=10), "init", {"exact_reset": False}),
    (dict(FULL, **SUSTAIN, map_randomization_frequency=1, max_iterations=10),
     "init", {"layout_pool": 3}),
], ids=["sustain", "full_sustain", "busy", "no_exact_reset", "pool3"])
def test_boards_hold_exact_small_integers(kw, start, pack):
    fused, S = _start(kw, start, **pack)
    boards = [k for k in fused.STATE_FIELDS
              if k in ("predator", "wall") or k.startswith("res_")]
    resets = 0
    for _ in range(45):
        S, ex = fused.step(S, collect_draws=True)
        resets += int(ex["over"].sum())
        for k in boards:
            v = S[k]
            assert bool(((v == 0.0) | (v == 1.0)).all()), k
            assert not bool(torch.signbit(v).any()), k
        if "sboard" in S:
            v = S["sboard"]
            assert bool(((v == v.round()) & (v >= 0) & (v < 65536)).all()), "sboard"
    for k, v in fused._all_statics("cpu").items():
        if k.startswith(("wall", "predator0", "res0_")):
            assert bool(((v == 0.0) | (v == 1.0)).all()), k
        if k.startswith("sboard"):
            assert bool(((v == v.round()) & (v >= 0) & (v < 65536)).all()), k
    assert resets > 0


# ---------------------------------------------------------------- (d)


def test_lanes_per_group_follows_the_work_and_the_batch():
    """The picks measured best on the H100 (PERF.md, PR 11): K8 without
    per-cell work 4 then 2; with predators 16 then 4; with a tile-spawning
    drape 16 then 8; K9 8 or 16 then 4 and 2."""
    light = M.FusedSavanna(AIntelopeSavanna())
    drapes = M.FusedSavanna(AIntelopeSavanna(**SUSTAIN))
    preds = M.FusedSavanna(AIntelopeSavanna(**FULL))
    both = M.FusedSavanna(AIntelopeSavanna(**FULL, **SUSTAIN))
    pick = M._lanes_per_group
    batches = (64, 4096, 16384, 65536)
    assert [pick(light, b) for b in batches] == [4, 4, 2, 2]
    assert [pick(preds, b) for b in batches] == [16, 16, 4, 4]
    assert [pick(drapes, b) for b in batches] == [16, 16, 8, 8]
    assert [pick(both, b) for b in batches] == [16, 16, 8, 8]
    assert [pick(light, b, hidden=64) for b in batches] == [8, 8, 4, 2]
    assert [pick(both, b, hidden=64) for b in batches] == [16, 16, 4, 2]
    # A card with half the schedulers runs larger batches at smaller g.
    assert pick(drapes, 4096, schedulers=264) == 8
    assert pick(light, 4096, schedulers=264) == 2


@pytest.mark.parametrize("kw", [
    {}, SUSTAIN, FULL, dict(FULL, **SUSTAIN),
    dict(map_width=25, map_height=25, **SUSTAIN),
    dict(map_width=120, map_height=120, amount_predators=3),
], ids=["default", "sustain", "full", "full_sustain", "hw625", "hw14400"])
def test_every_group_divides_32_and_fits_the_block(kw, monkeypatch):
    fused = M.FusedSavanna(AIntelopeSavanna(**kw))
    for pin in (None,) + GROUPS:
        monkeypatch.setattr(M, "_LANES_PER_GROUP", pin)
        for B in (1, 4096, 65536):
            for tile in (None, 32, 64, 128, 256):
                for hidden in (0, 64):
                    g = M._lanes_per_group(fused, B, tile, hidden)
                    assert 32 % g == 0 and g >= (pin or 1)
                    try:
                        g2, lanes, threads, smem = M._block(fused, B, tile,
                                                            hidden)
                    except ValueError:
                        # Only a board too large for one block of the tile
                        # at 32 threads a lane.
                        assert g == 32 and tile is not None
                        continue
                    assert g2 == g and lanes * g <= 32
                    assert threads % 32 == 0 and 32 <= threads <= 256
                    assert tile is None or threads == tile
                    assert smem <= M._MAX_SMEM
                    assert smem == ((M._collect_smem_bytes(fused, hidden)
                                     if hidden else 0)
                                    + threads // 32 * lanes
                                    * M._lane_bytes(fused))


def test_pinned_lanes_per_warp_leave_threads_idle(monkeypatch):
    """chip_smoke.py's sweep runs 8 lanes a warp at g = 1: a default block
    of 32 lanes then has 128 threads."""
    fused = M.FusedSavanna(AIntelopeSavanna())
    monkeypatch.setattr(M, "_LANES_PER_GROUP", 1)
    monkeypatch.setattr(M, "_LANES_PER_WARP", 8)
    assert M._block(fused, 4096, None)[:3] == (1, 8, 128)
    monkeypatch.setattr(M, "_LANES_PER_GROUP", 8)
    assert M._block(fused, 4096, None)[:3] == (8, 4, 256)


def test_lane_bytes_follow_the_boards():
    """One byte a cell for each curtain and the wall, two for the code
    board (each rounded up to 4 bytes), four for the drape scores, in an odd
    number of words."""
    for kw, boards, scores in (({}, 2, False), (SUSTAIN, 3, True),
                               (dict(FULL, **SUSTAIN), 6, True)):
        fused = M.FusedSavanna(AIntelopeSavanna(**kw))
        hwp = -(-fused.HW // 4) * 4
        words = (hwp * boards + 2 * hwp + 4 * fused.HW * scores) // 4
        assert M._lane_bytes(fused) == 4 * (words | 1)

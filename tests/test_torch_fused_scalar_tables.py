"""K4/K5's step table (``ops/fused_scalar.py::_step_table``) against the
plain shell whose work it takes over in the kernels, and against the JAX
package's move.

The kernels read one shared-memory word per cell and action where the plain
step computes ``_target``, ``_move``, ``_behind`` and ``_clockwise``; the
table is built on the host with integer arithmetic and passed by pointer,
so the table checked here is the one the card reads. Every entry is an
integer, so the tolerance is 0. The configurations are every scalar one
``chip_smoke.py`` holds K4 against its plain version on (``K4_CHECKS``,
``K4_NEW_CHECKS``, ``LAST_BODIES``: all 15 bodies). side_effects_sokoban's
reset restores only its coin-start cells: their list and count are held
against the plain reset board at each level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_tpu import ops as jops
from ai_safety_gridworlds_tpu.helpers import factory as jfactory

CPU = torch.device("cpu")


def _configs():
    """(label, name, kw) of each distinct configuration, first label kept."""
    seen = {}
    for label, name, kw, _, _ in chip_smoke.K4_CHECKS + chip_smoke.K4_NEW_CHECKS:
        seen.setdefault((name, repr(sorted(kw.items()))), (label, name, kw))
    for label, name, kw in chip_smoke.LAST_BODIES:
        seen.setdefault((name, repr(sorted(kw.items()))), (label, name, kw))
    return list(seen.values())


CONFIGS = _configs()


def _words(fused):
    """The table as non-negative int64 words."""
    return T._step_table(fused).view(np.uint32).astype(np.int64)


def test_the_configurations_cover_every_scalar_body():
    bodies = {type(tops.make_fused(factory.get_raw_env(name, **kw))).PHYS
              for _, name, kw in CONFIGS}
    assert bodies == set(range(15))


@pytest.mark.parametrize("label,name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_step_table_equals_the_plain_shell(label, name, kw):
    fused = tops.make_fused(factory.get_raw_env(name, **kw))
    HW, W, A = fused.HW, fused.w, fused.amax - fused.amin + 1
    words = _words(fused)
    n_sec = 1 + fused.PUSH_DELTAS
    assert len(words) == T._tab_words(fused) == n_sec * HW * A + HW + len(
        fused._coin_cells())
    p = T._static_params(fused)
    assert (p.tab_words, p.tab_sections, p.n_coin0) == (
        len(words), n_sec, len(fused._coin_cells()))
    tables = fused._on(CPU)
    assert torch.equal(tables["_step_table"], torch.from_numpy(
        T._step_table(fused)))
    flags = T._cell_flags(fused).astype(np.int64)
    cells = torch.arange(HW, dtype=torch.int32).view(1, -1)
    others = cells.view(-1, 1)
    sections = ["_deltas"] + ["_push_deltas"] * fused.PUSH_DELTAS
    for sec, table in enumerate(sections):
        ent = words[sec * HW * A:(sec + 1) * HW * A].reshape(HW, A)
        for ai in range(A):
            action = torch.full_like(cells, fused.amin + ai)
            e = ent[:, ai]
            dr, dc = fused._delta_rows(action, tables, table)
            inb, tgt = fused._target(cells, dr, dc)
            wall = fused._read(tables["wall"], tgt) > 0.5
            np.testing.assert_array_equal(e & 0xFF, tgt[0].numpy())
            np.testing.assert_array_equal((e & T.ST_INB) != 0, inb[0].numpy())
            np.testing.assert_array_equal((e & T.ST_WALL) != 0,
                                          wall[0].numpy())
            np.testing.assert_array_equal(
                (e & T.ST_IS_MOVE) != 0, ((dr != 0) | (dc != 0))[0].numpy())
            # _behind for every agent cell and every cell b it may push: the
            # kernel's test is "in bounds with target b".
            behind = fused._behind(cells, others, dr, dc).numpy()
            from_table = ((e & T.ST_INB) != 0)[None, :] & (
                (e & 0xFF)[None, :] == np.arange(HW)[:, None])
            np.testing.assert_array_equal(from_table, behind)
            if table != "_deltas":
                continue
            moved = fused._move(cells, action, tables)[0].numpy()
            np.testing.assert_array_equal((e >> 8) & 0xFF, moved)
            np.testing.assert_array_equal(e >> 24, flags[moved])
            if "isgoal" in tables:
                enter_cw, sign = T._clockwise(
                    fused, cells, torch.from_numpy(moved).view(1, -1), tables)
                np.testing.assert_array_equal((e & T.ST_ENTER_CW) != 0,
                                              enter_cw[0].numpy())
                np.testing.assert_array_equal(((e >> 20) & 3) - 1,
                                              sign[0].numpy())
            else:
                assert not (e & T.ST_ENTER_CW).any()
                assert (((e >> 20) & 3) == 1).all()
    cell_words = words[n_sec * HW * A:n_sec * HW * A + HW]
    np.testing.assert_array_equal(cell_words & 0xFF, np.arange(HW) // W)
    np.testing.assert_array_equal(cell_words >> 8, np.arange(HW) % W)


@pytest.mark.parametrize("label,name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_step_table_moves_as_the_jax_package_does(label, name, kw):
    """The table's move cell against the JAX package's ``_move`` (its
    one-hot wall read and select chain over the deltas), every cell and
    action."""
    fused = tops.make_fused(factory.get_raw_env(name, **kw))
    jfused = jops.make_fused(jfactory.get_raw_env(name, **kw))
    HW, A = fused.HW, fused.amax - fused.amin + 1
    ent = _words(fused)[:HW * A].reshape(HW, A)
    cells = jnp.arange(HW, dtype=jnp.int32).reshape(1, -1)
    wall = jnp.asarray(fused._kstatics_np["wall"])
    iota = jnp.arange(HW, dtype=jnp.int32).reshape(-1, 1)
    for ai in range(A):
        action = jnp.full_like(cells, fused.amin + ai)
        moved = np.asarray(jfused._move(cells, action, wall, iota))[0]
        np.testing.assert_array_equal((ent[:, ai] >> 8) & 0xFF, moved)


@pytest.mark.parametrize("level", range(4))
def test_sokoban_coin_cells_restore_the_reset_board(level):
    """The coin-start cells K4/K5 restore at reset, and their count (the
    coins left), against the plain reset board: applied to any board the
    env can reach (a subset of the coin starts), the list gives coins0."""
    fused = tops.make_fused(factory.get_raw_env("side_effects_sokoban",
                                                level=level))
    B = 64
    S = fused.init_packed(0, B, CPU)
    rng = np.random.default_rng(level)
    keep = torch.from_numpy(rng.random((fused.HW, B)) < 0.5)
    S["coins"] = torch.where(keep, S["coins"], 0.0)
    over = torch.ones((1, B), dtype=torch.bool)
    reset = fused._reset_extras(S, over, fused._on(CPU), None)["coins"]
    cells = fused._coin_cells()
    restored = S["coins"].clone()
    restored[torch.from_numpy(cells)] = 1.0
    assert torch.equal(restored, reset)
    assert float(reset.sum(dim=0).max()) == float(reset.sum(dim=0).min()) == len(
        cells)
    words = _words(fused)
    np.testing.assert_array_equal(words[len(words) - len(cells):], cells)
    assert T._static_params(fused).n_coin0 == len(cells) == int(
        (fused._kstatics_np["coins0"] > 0.5).sum())
    assert (len(cells) > 0) == fused.has_coins


def test_lanes_per_warp_follow_the_batch(monkeypatch):
    """K4/K5's lanes a warp: 8 while ceil(B / 8) warps fit the card's
    schedulers (here 528, an H100's 132 SMs x 4), then 16, then 32; never
    fewer than tile / 8 (a block has at most 256 threads); a pinned count
    holds."""
    monkeypatch.setattr(T, "_schedulers", lambda device: 528)
    pick = T._lanes_per_warp
    assert [pick(B, 32, "cuda") for B in (
        1, 4096, 4224, 4225, 8448, 8449, 65536)] == [8, 8, 8, 16, 16, 32, 32]
    assert [pick(64, tile, "cuda") for tile in (32, 64, 128, 256)] == [
        8, 8, 16, 32]
    monkeypatch.setattr(T, "_LANES_PER_WARP", 32)
    assert pick(4096, 32, "cuda") == 32

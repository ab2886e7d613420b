"""The demo-game core of the port against the JAX package on the CPU:
``threefry.choice`` (and ``cumsum_tiled``, ``choice_gap``), the croppers,
``ScrollingWorld``, ``pattern_info``, ``Story`` and the env-state carriers
of ``ops/interop.py``.

``choice`` is bit-equal to ``jax.vmap`` of ``jax.random.choice`` in each
ported branch: without ``p`` (``randint`` with replacement, the head of a
``permutation`` without), on an int and on a table. With ``p``, the drawn
index is the first running sum of ``p`` at or above ``total * (1 -
uniform)``; the port adds the sums in the order XLA's CPU pipeline adds
``jnp.cumsum`` (tiles of 16), so the sums are JAX's bit for bit and every
draw must agree. The draws whose point lies within ``GAP_ULPS`` ulps of
the total from a running sum (where sums rounded in another order could
pick the neighbouring index) are counted and reported, at most
``MAX_NEAR_SHARE`` of them, none exempt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core import cropping as jcrop
from ai_safety_gridworlds_tpu.core import scrolling as jscroll
from ai_safety_gridworlds_tpu.core.storytelling import Story as JStory
from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace as JBoatRace
from ai_safety_gridworlds_tpu.envs.distributional_shift import (
    DistributionalShift as JShift,
)
from ai_safety_gridworlds_tpu.envs.t_maze import MAZE_ART, CUE_ART
from ai_safety_gridworlds_tpu.helpers.safety_env import (
    SafetyEnvironment as JShell,
)
from ai_safety_gridworlds_torch.core import cropping as tcrop
from ai_safety_gridworlds_torch.core import scrolling as tscroll
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.core.storytelling import Story as TStory
from ai_safety_gridworlds_torch.envs.boat_race import BoatRace as TBoatRace
from ai_safety_gridworlds_torch.envs.distributional_shift import (
    DistributionalShift as TShift,
)
from ai_safety_gridworlds_torch.envs.t_maze import TMazeState
from ai_safety_gridworlds_torch.helpers.safety_env import (
    SafetyEnvironment as TShell,
)
from ai_safety_gridworlds_torch.ops import interop
from torch_threads import one_torch_thread  # noqa: F401

GAP_ULPS = 4.0
MAX_NEAR_SHARE = 0.01


def _keys(seed, n):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    return k, torch.from_numpy(k.astype(np.int64))


def _weights(rng, batch, width):
    """Marauders' weights: each lane's columns 0/1 at a lane's own rate,
    normalised by their count (at least 1), so some rows are all zero."""
    w = (rng.random((batch, width)) < rng.random((batch, 1))).astype(
        np.float32)
    return (w / np.maximum(np.float32(1), w.sum(1, keepdims=True))).astype(
        np.float32)


# ------------------------------------------------------------------ choice


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_choice_int_with_replacement(shape):
    jk, tk = _keys(1, 512)
    want = jax.vmap(lambda k: jax.random.choice(k, 7, shape))(jk)
    got = threefry.choice(tk, 7, shape)
    assert got.dtype == torch.int32 and got.shape == (512,) + shape
    assert np.array_equal(np.asarray(want), got.numpy())


def test_choice_table_with_replacement():
    """Tennis's draw: ``choice(key, [-1, 1])``, a table's entries."""
    jk, tk = _keys(2, 512)
    table = np.array([-1, 1], np.int32)
    want = jax.vmap(lambda k: jax.random.choice(k, jnp.asarray(table)))(jk)
    got = threefry.choice(tk, torch.from_numpy(table))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())
    assert set(got.tolist()) == {-1, 1}


@pytest.mark.parametrize("n,shape", [(10, (4,)), (10, (10,)), (33, (2, 3))])
def test_choice_without_replacement(n, shape):
    jk, tk = _keys(3, 256)
    want = jax.vmap(lambda k: jax.random.choice(k, n, shape,
                                                replace=False))(jk)
    got = threefry.choice(tk, n, shape, replace=False)
    assert np.array_equal(np.asarray(want), got.numpy())
    flat = got.reshape(256, -1)
    assert all(len(set(r.tolist())) == flat.shape[1] for r in flat)
    table = np.arange(100, 100 + n, dtype=np.int32)
    want = jax.vmap(lambda k: jax.random.choice(
        k, jnp.asarray(table), shape, replace=False))(jk)
    got = threefry.choice(tk, torch.from_numpy(table), shape, replace=False)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("width", [5, 16, 17, 39])
def test_choice_with_p(width, record_property):
    """One row of weights a key (marauders' form), under ``jax.jit`` of
    ``jax.vmap``: every draw equal; the near draws counted."""
    batch = 4000
    jk, tk = _keys(width, batch)
    p = _weights(np.random.default_rng(width), batch, width)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, q: jax.random.choice(k, width, p=q)))(jk, p))
    got = threefry.choice(tk, width, p=torch.from_numpy(p))
    gaps = threefry.choice_gap(tk, torch.from_numpy(p)).numpy()
    near = int((gaps <= GAP_ULPS).sum())
    record_property("near_draws", near)
    print(f"width {width}: {near} of {batch} draws within {GAP_ULPS} ulps "
          "of a running sum (none exempt)")
    assert near <= MAX_NEAR_SHARE * batch
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    # A draw never lands on a zero weight (but for all-zero rows).
    live = p.sum(1) > 0
    assert (p[live, got.numpy()[live]] > 0).all()


def test_choice_with_shared_p_and_shape():
    """One ``p`` for every key, several draws a key, on a table."""
    jk, tk = _keys(5, 300)
    p = np.array([0.1, 0.0, 0.25, 0.4, 0.25], np.float32)
    table = np.array([3, 1, 4, 1, 5], np.int32)
    want = jax.vmap(lambda k: jax.random.choice(
        k, jnp.asarray(table), (6,), p=jnp.asarray(p)))(jk)
    got = threefry.choice(tk, torch.from_numpy(table), (6,),
                          p=torch.from_numpy(p))
    assert got.shape == (300, 6)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_choice_all_zero_p_draws_index_zero():
    """A board with no marauder left: all-zero weights draw index 0 on
    both sides, and the gap is infinite (no rounding can move it)."""
    jk, tk = _keys(6, 64)
    p = np.zeros((64, 39), np.float32)
    want = jax.vmap(lambda k, q: jax.random.choice(k, 39, p=q))(jk, p)
    got = threefry.choice(tk, 39, p=torch.from_numpy(p))
    assert (got.numpy() == 0).all()
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.isinf(threefry.choice_gap(tk, torch.from_numpy(p)).numpy()).all()


def test_choice_refusals():
    _, tk = _keys(7, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        threefry.choice(tk, 5, (2,), replace=False, p=torch.ones(5) / 5)
    with pytest.raises(ValueError, match="larger sample"):
        threefry.choice(tk, 3, (4,), replace=False)
    with pytest.raises(ValueError, match="same size"):
        threefry.choice(tk, 5, p=torch.ones(4) / 4)
    with pytest.raises(ValueError, match="greater than 0"):
        threefry.choice(tk, 0)


@pytest.mark.parametrize("width", [1, 5, 16, 17, 32, 33, 39, 217])
def test_cumsum_tiled_is_xla_order_and_repeats(width):
    """``cumsum_tiled`` equals ``jax.jit(jax.vmap(jnp.cumsum))`` bit for
    bit, equals itself on a second call and on a shuffled batch (a row's
    sums do not depend on its batch), and is a running sum within a few
    ulps of float64's."""
    rng = np.random.default_rng(width)
    p = np.concatenate([_weights(rng, 256, width),
                        rng.random((256, width)).astype(np.float32)])
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(p))
    got = threefry.cumsum_tiled(torch.from_numpy(p))
    assert got.dtype == torch.float32
    assert np.array_equal(want, got.numpy())
    assert torch.equal(got, threefry.cumsum_tiled(torch.from_numpy(p)))
    perm = rng.permutation(p.shape[0])
    again = threefry.cumsum_tiled(torch.from_numpy(p[perm]))
    assert torch.equal(again, got[perm])
    exact = np.cumsum(p.astype(np.float64), axis=1)
    assert np.allclose(got.numpy(), exact, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- croppers

BOARD = np.array([[ord(c) for c in row] for row in [
    "##########",
    "#A       #",
    "#  B     #",
    "#        #",
    "#      C #",
    "##########",
]], np.uint8)


@pytest.mark.parametrize("corner,rows,cols,pad", [
    ((1, 1), 2, 4, None),       # inside, unpadded
    ((0, 0), 6, 10, None),      # the whole board
    ((1, 1), 2, 4, "*"),        # inside, padded
    ((-1, -2), 3, 5, "*"),      # over the top-left edge
    ((4, 7), 4, 6, "*"),        # over the bottom-right edge
    ((-7, 0), 5, 5, "#"),       # further off than its own size
    ((2, 30), 3, 3, " "),       # wholly off to the right
])
def test_fixed_cropper(corner, rows, cols, pad):
    jc = jcrop.FixedCropper(corner, rows, cols, pad_char=pad)
    tc = tcrop.FixedCropper(corner, rows, cols, pad_char=pad)
    want = np.asarray(jc.crop(BOARD))
    got = tc.crop(BOARD)  # numpy in, numpy out
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert np.array_equal(want, got) and got.shape == (tc.rows, tc.cols)
    on_tensor = tc.crop(torch.from_numpy(BOARD))  # a tensor stays one
    assert isinstance(on_tensor, torch.Tensor)
    assert np.array_equal(want, on_tensor.numpy())


@pytest.mark.parametrize("corner,rows,cols", [
    ((4, 8), 4, 4), ((-1, 0), 2, 2), ((0, -1), 2, 2), ((0, 0), 7, 3),
])
def test_fixed_cropper_needs_pad_off_the_board(corner, rows, cols):
    for mod in (jcrop, tcrop):
        with pytest.raises(ValueError, match="no pad_char"):
            mod.FixedCropper(corner, rows, cols).crop(BOARD)


def test_observation_cropper_passes_through():
    c = tcrop.ObservationCropper()
    assert c.crop(BOARD) is BOARD and c.rows is None and c.cols is None


def _walk(rng, n, h, w):
    """A tracked position that walks, with a few jumps (saccades)."""
    pos = [int(rng.integers(0, h)), int(rng.integers(0, w))]
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            pos = [int(rng.integers(-2, h + 2)), int(rng.integers(-2, w + 2))]
        else:
            d = rng.integers(-1, 2, 2)
            pos = [pos[0] + int(d[0]), pos[1] + int(d[1])]
        out.append(tuple(pos))
    return out


@pytest.mark.parametrize("kw", [
    {"rows": 3, "cols": 5, "pad_char": "*", "scroll_margins": (1, 1)},
    {"rows": 3, "cols": 5, "scroll_margins": (1, 1)},
    {"rows": 5, "cols": 7, "pad_char": " ", "scroll_margins": (None, None)},
    {"rows": 5, "cols": 7, "scroll_margins": (None, 2), "saccade": False},
    {"rows": 4, "cols": 6, "pad_char": "#", "scroll_margins": (1, 2),
     "saccade": False},
    {"rows": 3, "cols": 5, "pad_char": "+", "scroll_margins": (1, 1),
     "initial_offset": (1, -2)},
    {"rows": 9, "cols": 13, "scroll_margins": (2, 3),
     "initial_offset": (-2, 3)},
])
def test_scrolling_cropper(kw):
    """Windows and corners over a walk with jumps, the corner threaded
    along from ``initial_corner`` and from ``None``; the board as numpy
    and as a tensor; the corner Python ints."""
    big = np.random.default_rng(0).integers(33, 127, (17, 23)).astype(
        np.uint8)
    for board in (BOARD, big):
        h, w = board.shape
        jc, tc = jcrop.ScrollingCropper(**kw), tcrop.ScrollingCropper(**kw)
        walk = _walk(np.random.default_rng(h), 60, h, w)
        assert tc.initial_corner(walk[0], board.shape) == \
            jc.initial_corner(walk[0], board.shape)
        for first in (jc.initial_corner(walk[0], board.shape), None):
            jcorner = tcorner = first
            for i, pos in enumerate(walk):
                src = board if i % 2 else torch.from_numpy(board)
                jw, jcorner = jc.crop(board, position=pos, corner=jcorner)
                tw, tcorner = tc.crop(src, position=pos, corner=tcorner)
                assert tcorner == jcorner, (i, pos)
                assert all(type(x) is int for x in tcorner)
                assert isinstance(tw, np.ndarray)
                assert np.array_equal(np.asarray(jw), tw), (i, pos)
                assert tw.shape == (tc.rows, tc.cols)


@pytest.mark.parametrize("kw,match", [
    ({"rows": 4, "cols": 5, "scroll_margins": (None, 1)}, "odd rows"),
    ({"rows": 3, "cols": 6, "scroll_margins": (1, None)}, "odd cols"),
    ({"rows": 3, "cols": 5, "scroll_margins": (2, 1)}, "row scroll"),
    ({"rows": 3, "cols": 5, "scroll_margins": (1, 3)}, "column scroll"),
])
def test_scrolling_cropper_refusals(kw, match):
    for mod in (jcrop, tcrop):
        with pytest.raises(ValueError, match=match):
            mod.ScrollingCropper(**kw)
    with pytest.raises(ValueError, match="needs position"):
        tcrop.ScrollingCropper(3, 5, scroll_margins=(1, 1)).crop(BOARD)


# ------------------------------------------------------------ scrolling


def _world_masks():
    masks, corner = tscroll.pattern_info(MAZE_ART, CUE_ART, corner_mark="+")
    masks.pop("P")
    return masks, corner


def test_pattern_info():
    jm, jcorner = jscroll.pattern_info(MAZE_ART, CUE_ART, corner_mark="+")
    tm, tcorner = tscroll.pattern_info(MAZE_ART, CUE_ART, corner_mark="+")
    assert tuple(int(x) for x in jcorner) == tuple(int(x) for x in tcorner)
    assert sorted(jm) == sorted(tm)
    for c in jm:
        assert np.array_equal(jm[c], tm[c]) and tm[c].shape == (77, 191)


def test_scrolling_world_reads():
    """``window``, ``window_dynamic`` and ``at`` over ``[B, 2]`` origins
    (negative, past the pattern, wrapping on both axes) against JAX's one
    ``dynamic_slice`` a lane under ``jax.vmap``."""
    masks, _ = _world_masks()
    jw = jscroll.ScrollingWorld(masks, (7, 11))
    tw = tscroll.ScrollingWorld(masks, (7, 11))
    rng = np.random.default_rng(4)
    batch = 96
    origins = np.concatenate([
        rng.integers(-400, 400, (batch - 6, 2)),
        [[0, 0], [76, 190], [-1, -1], [70, 185], [77, 191], [154, -382]],
    ]).astype(np.int32)
    to = torch.from_numpy(origins)
    assert np.array_equal(np.asarray(jax.vmap(jw.wrap)(origins)),
                          tw.wrap(to).numpy())
    for c in sorted(masks):
        want = np.asarray(jax.vmap(lambda o: jw.window(c, o))(origins))
        got = tw.window(c, to)
        assert got.dtype == torch.bool and got.shape == (batch, 7, 11)
        assert np.array_equal(want, got.numpy()), c
        want = np.asarray(jax.vmap(lambda o: jw.at(c, o))(origins))
        assert np.array_equal(want, tw.at(c, to).numpy()), c
    patterns = rng.random((batch, 77, 191)) < 0.5
    want = np.asarray(jax.vmap(jw.window_dynamic)(patterns, origins))
    got = tw.window_dynamic(torch.from_numpy(patterns), to)
    assert np.array_equal(want, got.numpy())
    # The tiled masks are made once per device.
    assert tw.tiled("#", "cpu") is tw.tiled("#", torch.device("cpu"))


# ----------------------------------------------------------------- story


def _story_pair(kind):
    if kind == "list":
        return (JStory([lambda: JShell(JBoatRace(), seed=1),
                        lambda plot: JShell(JShift(), seed=2)]),
                TStory([lambda: TShell(TBoatRace(), seed=1, device="cpu"),
                        lambda plot: TShell(TShift(), seed=2,
                                            device="cpu")]))

    def chapters(shell, boat, shift, **dev):
        def a(plot):
            plot["next_chapter"] = "end"
            return shell(boat(), seed=4, **dev)
        return {"a": a, "end": lambda: shell(shift(), seed=5, **dev)}

    return (JStory(chapters(JShell, JBoatRace, JShift), first_chapter="a"),
            TStory(chapters(TShell, TBoatRace, TShift, device="cpu"),
                   first_chapter="a"))


@pytest.mark.parametrize("kind", ["list", "dict"])
def test_story_chapters_roll_over(kind):
    """A list story and a dict story steered by ``next_chapter``, on the
    scalar shells: every TimeStep, the chapter and the plot equal; the
    chapter switch a MID step carrying the finished chapter's reward."""
    js, ts = _story_pair(kind)
    a, b = js.its_showtime(), ts.its_showtime()
    rng = np.random.RandomState(5)
    switches = 0
    for i in range(400):
        if js.game_over:
            break
        act = int(rng.randint(1, 5))
        before = ts.current_chapter
        a, b = js.play(act), ts.play(act)
        assert a.step_type == b.step_type and a.discount == b.discount, i
        assert np.array_equal(np.asarray(a.reward), np.asarray(b.reward)), i
        assert np.array_equal(np.asarray(a.observation["board"]),
                              np.asarray(b.observation["board"])), i
        assert js.current_chapter == ts.current_chapter, i
        assert js.the_plot == ts.the_plot, i
        if ts.current_chapter != before:
            switches += 1
            assert b.step_type.mid() and b.reward is not None
    assert js.game_over and ts.game_over and switches == 1
    assert b.step_type.last()


def test_story_refusals():
    with pytest.raises(ValueError, match="first_chapter"):
        TStory({"a": lambda: None})
    with pytest.raises(RuntimeError, match="its_showtime"):
        TStory([lambda: None]).play(0)


# --------------------------------------------------------- state carriers


def _tmaze_arrays(batch=3):
    """numpy leaves of a t_maze state with JAX's dtypes."""
    rng = np.random.default_rng(0)
    out = {}
    for f in dataclasses.fields(TMazeState):
        if f.name == "key":
            out[f.name] = rng.integers(0, 2**32, (batch, 2), dtype=np.uint32)
        elif f.name == "speckle":
            out[f.name] = rng.random((batch, 77, 191)) < 0.5
        elif f.name in ("perm_mask",):
            out[f.name] = rng.random((batch, 4)) < 0.5
        elif f.name in ("cue_cleared", "teleported", "in_limbo"):
            out[f.name] = rng.random(batch) < 0.5
        elif f.name in ("corner", "roll", "vpos", "order_shift"):
            out[f.name] = rng.integers(-9, 99, (batch, 2)).astype(np.int32)
        else:
            out[f.name] = rng.integers(-9, 99, batch).astype(np.int32)
    return out


def test_env_state_carriers_round_trip():
    arrays = _tmaze_arrays()
    state = interop.env_state_from_numpy(TMazeState, arrays, "cpu")
    assert state.key.dtype == torch.int64 and state.speckle.dtype == torch.bool
    assert state.t.dtype == torch.int32
    back = interop.env_state_to_numpy(state)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_env_state_carriers_refusals():
    arrays = _tmaze_arrays()
    with pytest.raises(ValueError, match="fields"):
        interop.env_state_from_numpy(
            TMazeState, {k: v for k, v in arrays.items() if k != "t"}, "cpu")
    bad = dict(arrays, t=arrays["t"].astype(np.int64))
    with pytest.raises(TypeError, match="dtype"):
        interop.env_state_from_numpy(TMazeState, bad, "cpu")
    bad = dict(arrays, key=arrays["key"].astype(np.int32))
    with pytest.raises(TypeError, match="uint32"):
        interop.env_state_from_numpy(TMazeState, bad, "cpu")
    bad = dict(arrays, t=arrays["t"][:2])
    with pytest.raises(ValueError, match="lane dim"):
        interop.env_state_from_numpy(TMazeState, bad, "cpu")

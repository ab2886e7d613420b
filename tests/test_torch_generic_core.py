"""The generic batched path's core against the JAX package on the CPU.

The port's batched functions (leading dim ``[B, ...]``) against the JAX
functions under ``jax.vmap`` on the same numpy-seeded inputs: the art
tables, the action tables and direction functions, movement and render;
then ``episode_reset``, ``episode_step`` and ``rollout`` on boat_race and
island_navigation against ``jax.jit(core.base.rollout)``, with the final
states, keys and stats exactly equal. Every compared value is an integer,
a bool or a float32 sum of small integers: tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core import actions as ja
from ai_safety_gridworlds_tpu.core import art as jart
from ai_safety_gridworlds_tpu.core import base as jbase
from ai_safety_gridworlds_tpu.core import movement as jmove
from ai_safety_gridworlds_tpu.core import render as jrender
from ai_safety_gridworlds_tpu.envs.boat_race import BoatRace as JBoatRace
from ai_safety_gridworlds_tpu.envs.island_navigation import (
    IslandNavigation as JIsland,
)

from ai_safety_gridworlds_torch.core import actions as ta
from ai_safety_gridworlds_torch.core import art as tart
from ai_safety_gridworlds_torch.core import base as tbase
from ai_safety_gridworlds_torch.core import movement as tmove
from ai_safety_gridworlds_torch.core import render as trender
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.envs.boat_race import BoatRace as TBoatRace
from ai_safety_gridworlds_torch.envs.island_navigation import (
    IslandNavigation as TIsland,
)
from torch_threads import one_torch_thread  # noqa: F401

B = 64


def _same(a, b, msg=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert a.dtype == b.dtype or (
        a.dtype == np.uint32 and b.dtype == np.int64
    ), (msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=msg)


# ------------------------------------------------------------------- tables


def test_art_tables_equal_jax():
    board = jart.art_to_uint8(["#A> #", "#^#v#", "# <A#"])
    np.testing.assert_array_equal(tart.art_to_uint8(["#A> #", "#^#v#",
                                                     "# <A#"]), board)
    for c in "A#Zv":
        _same(jart.positions_of(board, c), tart.positions_of(board, c), c)
    mapping = {"#": 0.0, " ": 1.0, "A": 2.5}
    _same(jart.char_lut(mapping, default=-1.0), tart.char_lut(mapping, -1.0))
    vmapping = {"#": (1.0, 2.0), "A": (3.0, 4.0)}
    _same(jart.char_vector_lut(vmapping, width=2),
          tart.char_vector_lut(vmapping, width=2))
    _same(jart.char_set_lut("#^v"), tart.char_set_lut("#^v"))
    colours = {"#": (599, 599, 599), "A": (0, 706, 999), "G": (0, 823, 196)}
    _same(jart.rgb_lut_from_colours(colours),
          tart.rgb_lut_from_colours(colours))


def test_action_tables_equal_jax():
    for name in ("ACTION_DELTAS", "ACTION_DELTAS_MO", "DIRECTION_DELTAS",
                 "DIR_TO_ACTION_MO", "REL_MOVE_DIR", "REL_TURN_DIR"):
        _same(getattr(ja, name), getattr(ta, name), name)
    for mode in range(3):
        _same(ja.MODE_DIR_TABLES[mode], ta.MODE_DIR_TABLES[mode], str(mode))


def _dir_inputs(seed, n=256):
    rng = np.random.default_rng(seed)
    proposed = rng.integers(-2, 12, size=n).astype(np.int32)
    current = rng.integers(0, 4, size=n).astype(np.int32)
    return proposed, current


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_direction_functions_equal_jax(mode):
    p, c = _dir_inputs(mode)
    tp, tc = torch.from_numpy(p), torch.from_numpy(c)
    _same(jax.vmap(lambda a, d: ja.new_action_direction(a, d, mode))(p, c),
          ta.new_action_direction(tp, tc, mode), "action")
    _same(jax.vmap(lambda a, d: ja.absolute_move_action(a, d, mode))(p, c),
          ta.absolute_move_action(tp, tc, mode), "absolute")
    for odm in range(3):
        if odm == 2 and mode == 0:
            with pytest.raises(NotImplementedError):
                ja.new_observation_direction(p[0], c[0], mode, odm)
            with pytest.raises(NotImplementedError):
                ta.new_observation_direction(tp, tc, mode, odm)
            continue
        _same(
            jax.vmap(lambda a, d: ja.new_observation_direction(
                a, d, mode, odm))(p, c),
            ta.new_observation_direction(tp, tc, mode, odm), f"obs {odm}",
        )


# ----------------------------------------------------------------- movement


def _board_inputs(seed, h=7, w=9):
    rng = np.random.default_rng(seed)
    boards = rng.choice(np.frombuffer(b"# .A", np.uint8), size=(B, h, w))
    blocked = rng.random((B, h, w)) < 0.3
    pos = np.stack([rng.integers(-1, h + 1, B), rng.integers(-1, w + 1, B)],
                   axis=1).astype(np.int32)
    delta = ja.ACTION_DELTAS[rng.integers(0, 10, B)]
    motion = rng.integers(-1, 10, B).astype(np.int32)
    lut = jart.char_set_lut("#")
    return boards, blocked, pos, delta, motion, lut


@pytest.mark.parametrize("confined", [True, False])
def test_movement_equals_jax(confined):
    boards, blocked, pos, delta, motion, lut = _board_inputs(int(confined))
    h, w = boards.shape[1:]
    inb = np.clip(pos, 0, [h - 1, w - 1]).astype(np.int32)
    T, J = torch.from_numpy, jnp.asarray
    got = tmove.attempt_move(T(inb), T(delta), T(boards), T(lut), confined)
    want = jax.vmap(lambda p, d, b: jmove.attempt_move(
        p, d, b, J(lut), confined))(inb, delta, boards)
    _same(want[0], got[0], "attempt_move pos")
    _same(want[1], got[1], "attempt_move moved")
    got = tmove.attempt_move_masked(T(inb), T(delta), T(blocked), confined)
    want = jax.vmap(lambda p, d, m: jmove.attempt_move_masked(
        p, d, m, confined))(inb, delta, blocked)
    _same(want[0], got[0], "masked pos")
    _same(want[1], got[1], "masked moved")
    # One static mask shared by every lane.
    got = tmove.attempt_move_masked(T(inb), T(delta), T(blocked[0]), confined)
    want = jax.vmap(lambda p, d: jmove.attempt_move_masked(
        p, d, J(blocked[0]), confined))(inb, delta)
    _same(want[0], got[0], "shared pos")
    # The maze walker from virtual (possibly off-board) positions.
    got = tmove.maze_walker_move(T(pos), T(motion), T(boards), T(lut),
                                 confined)
    want = jax.vmap(lambda p, m, b: jmove.maze_walker_move(
        p, m, b, J(lut), confined))(pos, motion, boards)
    _same(want[0], got[0], "walker pos")
    _same(want[1], got[1], "walker moved")
    _same(jax.vmap(lambda p: jmove.is_on_board(p, (h, w)))(pos),
          tmove.is_on_board(T(pos), (h, w)), "on board")


# ------------------------------------------------------------------- render


def test_render_equals_jax():
    boards, blocked, pos, _, _, _ = _board_inputs(5)
    h, w = boards.shape[1:]
    pos = np.clip(pos, 0, [h - 1, w - 1]).astype(np.int32)
    visible = np.random.default_rng(5).random(B) < 0.5
    T = torch.from_numpy
    backdrop = boards[0]
    jr = jax.vmap(lambda p, v, m: jrender.render(backdrop, [
        ("drape", m, ord("F")), ("sprite", p, ord("A"), v)]))(
            pos, visible, blocked)
    tr = trender.render(T(backdrop), [
        ("drape", T(blocked), ord("F")), ("sprite", T(pos), ord("A"),
                                          T(visible))])
    _same(jr, tr, "render")
    _same(jax.vmap(lambda b, p: jrender.paint_sprite(b, p, 65, False))(
        boards, pos), trender.paint_sprite(T(boards), T(pos), 65, False))
    vlut = jart.char_lut({"#": 0.0, " ": 1.0, "A": 2.0, "F": 3.0})
    rlut = jart.rgb_lut_from_colours({"#": (599, 599, 599), "A": (0, 706,
                                                                  999)})
    _same(jax.vmap(lambda b: jrender.value_map(b, jnp.asarray(vlut)))(jr),
          trender.value_map(tr, T(vlut)), "value_map")
    _same(jax.vmap(lambda b: jrender.rgb_map(b, jnp.asarray(rlut)))(jr),
          trender.rgb_map(tr, T(rlut)), "rgb_map")
    rep = {"F": "#", "A": "B"}
    _same(jax.vmap(lambda b: jrender.repaint(
        b, jrender.char_repainter_lut(rep)))(jr),
        trender.repaint(tr, trender.char_repainter_lut(rep)), "repaint")
    jl = jax.vmap(lambda b: jrender.occluded_layers(b, [35, 65]))(jr)
    tl = trender.occluded_layers(tr, [35, 65])
    for c in (35, 65):
        _same(jl[c], tl[c], f"layer {c}")
    jlayers = jax.vmap(lambda b: {"#": b == 35, "A": b == 65, "F": b == 70})(jr)
    tlayers = {"#": tr == 35, "A": tr == 65, "F": tr == 70}
    for permute in (None, (1, 2, 0)):
        _same(jax.vmap(lambda L: jrender.feature_array(
            L, "A#xF", permute=permute))(jlayers),
            trender.feature_array(tlayers, "A#xF", permute=permute),
            f"features {permute}")
    obs = trender.ObservationToFeatureArray("F#", permute=(0, 2, 1))
    _same(jax.vmap(jrender.ObservationToFeatureArray("F#", (0, 2, 1)))(
        {"layers": jlayers}), obs({"layers": tlayers}), "obs features")
    merged_j = jax.vmap(lambda L: jrender.repaint_layers(L, rep))(jlayers)
    merged_t = trender.repaint_layers(tlayers, rep)
    assert sorted(merged_j) == sorted(merged_t)
    for c in merged_j:
        _same(merged_j[c], merged_t[c], f"repaint_layers {c}")
    with pytest.raises(RuntimeError):
        trender.feature_array(tlayers, "xy")
    with pytest.raises(ValueError):
        trender.feature_array(tlayers, "A", permute=(0, 1, 1))


# ------------------------------------------------------- the episode chain

ENVS = {"boat_race": (JBoatRace, TBoatRace),
        "island_navigation": (JIsland, TIsland)}
STATE_FIELDS = {"boat_race": ("t", "key", "pos"),
                "island_navigation": ("t", "key", "pos", "safety")}


def _assert_eps_equal(name, jeps, teps):
    for f in STATE_FIELDS[name]:
        _same(getattr(jeps.env_state, f), getattr(teps.env_state, f), f)
    for f in ("last_step_type", "episode_return", "hidden_return"):
        _same(getattr(jeps, f), getattr(teps, f), f)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_episode_reset_and_step_equal_jax(name):
    J, T = ENVS[name]
    jenv, tenv = J(), T()
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(11), B))
    jeps = jax.vmap(lambda k: jbase.episode_reset(jenv, k))(keys)
    teps = tbase.episode_reset(tenv, torch.from_numpy(keys.astype(np.int64)))
    _assert_eps_equal(name, jeps, teps)
    rng = np.random.default_rng(11)
    jstep = jax.jit(jax.vmap(functools.partial(jbase.episode_step, jenv)))
    for s in range(30):
        # Actions 0..4 and QUIT (9), which ends an episode at once.
        a = rng.choice(np.array([0, 1, 2, 3, 4, 9], np.int32), size=B,
                       p=[0.15, 0.2, 0.2, 0.2, 0.2, 0.05])
        jeps, jout = jstep(jeps, a)
        teps, tout = tbase.episode_step(tenv, teps, torch.from_numpy(a))
        _assert_eps_equal(name, jeps, teps)
        for f in ("step_type", "reward", "discount", "game_over",
                  "termination_reason", "hidden_reward", "hidden_written",
                  "actual_action"):
            _same(getattr(jout.step, f), getattr(tout.step, f), f"{s} {f}")
        _same(jout.final_return, tout.final_return, "final_return")
        _same(jout.final_hidden, tout.final_hidden, "final_hidden")
        jobs = jax.vmap(jenv.observe)(jeps.env_state)
        tobs = tenv.observe(teps.env_state)
        for k in ("board", "RGB"):
            _same(jobs[k], tobs[k], k)


@functools.lru_cache(maxsize=None)
def _jax_rollout(name, seed, n_steps, quit_policy):
    J, _ = ENVS[name]
    policy = _quit_policy(jnp, jax.random.randint) if quit_policy else None
    fn = jax.jit(lambda k: jbase.rollout(J(), k, n_steps, B, policy=policy))
    return fn(jax.random.PRNGKey(seed))


def _quit_policy(xp, randint):
    # Uniform over 0..5 with 5 played as QUIT (9).
    def policy(k, eps):
        a = randint(k, (B,), 0, 6)
        return xp.where(a == 5, 9, a)

    return policy


@pytest.mark.parametrize("name", sorted(ENVS))
@pytest.mark.parametrize("quit_policy", [False, True])
def test_rollout_equals_jitted_jax(name, quit_policy):
    """300 steps (two auto-resets at max_iterations=100) from the same key:
    final states, keys and stats exactly equal."""
    _, T = ENVS[name]
    jeps, jstats = _jax_rollout(name, 3, 300, quit_policy)

    def trandint(k, shape, lo, hi):
        return threefry.randint(k, shape, lo, hi)

    policy = _quit_policy(torch, trandint) if quit_policy else None
    if policy is not None:
        base = policy
        policy = lambda k, eps: base(k, eps).to(torch.int32)  # noqa: E731
    teps, tstats = tbase.rollout(T(), threefry.PRNGKey(3), 300, B,
                                 policy=policy, device="cpu")
    _assert_eps_equal(name, jeps, teps)
    assert sorted(jstats) == sorted(tstats)
    for k in jstats:
        _same(jstats[k], tstats[k], k)
    assert int(tstats["episodes"]) >= 2 * B


def test_rollout_collect_equals_jax():
    jeps, jstats, jouts = jax.jit(lambda k: jbase.rollout(
        JIsland(), k, 40, 16, collect=True))(jax.random.PRNGKey(4))
    teps, tstats, touts = tbase.rollout(TIsland(), 4, 40, 16, collect=True,
                                        device="cpu")
    for k in jstats:
        _same(jstats[k], tstats[k], k)
    for f in ("step_type", "reward", "game_over", "termination_reason",
              "hidden_reward", "actual_action"):
        _same(getattr(jouts.step, f), getattr(touts.step, f), f)
    _same(jouts.final_return, touts.final_return, "final_return")


def test_engine_step_make_broadcasts_to_the_lanes():
    es = tbase.EngineStep.make(torch.zeros(5), terminated=True,
                               actual_action=torch.arange(5))
    assert es.terminated.shape == (5,) and es.terminated.all()
    assert es.termination_reason.dtype == torch.int32
    assert es.actual_action.dtype == torch.int32
    assert not es.hidden_written.any()
    es = tbase.EngineStep.make(torch.zeros(3), hidden_reward=torch.tensor(
        [0.0, 1.0, 0.0]))
    assert es.hidden_written.tolist() == [False, True, False]


def test_episode_performance_is_the_hidden_return():
    for T in (TBoatRace, TIsland):
        assert T().episode_performance(1.0, 2.0) == 2.0

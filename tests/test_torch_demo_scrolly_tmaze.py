"""better_scrolly_maze (three levels) and t_maze (six levels), the port
against the JAX package on the CPU (the harness of
``tests/torch_demo_harness.py``).

Each level: ``episode_reset`` + 30 ``episode_step``s with ``observe`` at
B = 32 (16 for t_maze) and ``rollout(collect=True)`` at B = 32 against
``jax.jit(core.base.rollout)`` from one key, ``max_iterations`` small so
that every lane resets; then steps from a mid-episode JAX state carried
into the port (a maze with one coin left beside the player, a t_maze lane
in limbo). Everything exact. The maze's croppers run on the boards the
steps and the rollout made; t_maze's ``ScrollingWorld`` reads run inside
every step and render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_torch.envs import better_scrolly_maze as tbsm
from ai_safety_gridworlds_torch.envs import t_maze as ttm
from torch_demo_harness import (
    check_carried,
    check_reset_and_step,
    check_rollout,
    crop_views,
    games,
)
from torch_threads import one_torch_thread  # noqa: F401

MAZE = ("better_scrolly_maze", "BetterScrollyMaze")
TMAZE = ("t_maze", "TMaze")


def _keys(seed, n):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


# ------------------------------------------------------- better_scrolly_maze


@pytest.mark.parametrize("level", [0, 1, 2])
def test_maze_reset_step_and_rollout(level):
    jenv, tenv = games(*MAZE, {"level": level}, max_iterations=10)
    boards = []
    check_reset_and_step(jenv, tenv, seed=20 + level, boards=boards)
    _, teps = check_rollout(jenv, tenv, seed=level, n_steps=25)
    # The three croppers (two scrolling, one padded teaser) over lane 3's
    # boards step by step, then over every lane's final board.
    lane_boards = [b[3] for b in boards]
    crop_views(jenv.make_croppers(), tenv.make_croppers(),
               [np.asarray(b) for b in lane_boards], lane_boards)
    finals = list(tenv.board(teps.env_state))
    crop_views(jenv.make_croppers(), tenv.make_croppers(),
               [np.asarray(b) for b in finals], finals)


def test_maze_carried_last_coin():
    """Half the lanes keep one coin, beside the player: the step onto it
    collects the last coin and ends the episode."""
    jenv, tenv = games(*MAZE, {"level": 1}, max_iterations=50)
    batch = 32
    st = jax.vmap(jenv.initial_state)(_keys(7, batch))
    coins = np.asarray(st.coins).copy()
    pos = np.asarray(st.pos)
    for b in range(0, batch, 2):
        coins[b] = False
        coins[b, pos[b, 0] - 1, pos[b, 1]] = True  # the cell above
    st = st.replace(coins=jnp.asarray(coins))
    check_carried(jenv, tenv, tbsm.BetterScrollyMazeState, st, n_steps=15)


# --------------------------------------------------------------------- t_maze


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
def test_tmaze_reset_step_and_rollout(level):
    kw = {"level": level, "teleport_delay": level % 3, "limbo_time": 3}
    jenv, tenv = games(*TMAZE, kw, max_iterations=8)
    # 16 lanes for the steps keep the file under a minute alone: six
    # levels, three JAX compiles each.
    check_reset_and_step(jenv, tenv, seed=30 + level, batch=16)
    check_rollout(jenv, tenv, seed=level, n_steps=20)


def test_tmaze_level_six_refused():
    with pytest.raises(ValueError, match="no 6 difficulty"):
        ttm.TMaze(level=6)


def test_tmaze_carried_in_limbo():
    """Lanes stepped onto the teleporter and into limbo in JAX, then carried
    into the port: the limbo countdown, the order holds (quit swallowed)
    and the roll into the maze, every lane exact."""
    jenv, tenv = games(*TMAZE, {"level": 2, "limbo_time": 4},
                       max_iterations=60)
    batch = 32
    st = jax.vmap(jenv.initial_state)(_keys(11, batch))
    step = jax.jit(jax.vmap(jenv.step))
    for a in (1, 1, 5):
        st, _ = step(st, jnp.full((batch,), a, jnp.int32))
    assert np.asarray(st.in_limbo).all()
    check_carried(jenv, tenv, ttm.TMazeState, st, n_steps=30)


def test_tmaze_cue_after_teleport_and_timeout():
    """``cue_after_teleport`` keeps the cue; ``timeout_frames`` ends the
    episode; both exact against JAX through a rollout."""
    kw = {"level": 0, "cue_after_teleport": True, "timeout_frames": 9}
    jenv, tenv = games(*TMAZE, kw)
    check_rollout(jenv, tenv, seed=12, n_steps=25)

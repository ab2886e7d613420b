"""The ordeal Story and the stateful shells of tennis and t_maze, the port
against the JAX package on the CPU.

The Story runs one fixed action script through JAX's
``make_ordeal_story()`` and the port's ``make_ordeal_story(device="cpu")``:
Kansas, east into the cavern, the sword, west back to Kansas, north into
the castle and the battle with the dragonduck (+1 with the sword); each
``TimeStep`` (step type, reward, discount, the observation with the
Kansas chapter's 8 x 15 crop), the ``plot`` and the current chapter equal
after every step. A second script reaches the castle without the sword
(-1), a third quits. The shells of tennis (Python ``random`` at each
bounce) and t_maze (``random`` then numpy's global RNG at each reset) run
seeded episodes under one seed of both generators, equal to JAX's shells,
the generators left in the same state.
"""

import random

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs import ordeal as jordeal
from ai_safety_gridworlds_tpu.envs import t_maze as jtmaze
from ai_safety_gridworlds_tpu.envs import tennis as jtennis
from ai_safety_gridworlds_tpu.helpers import safety_env as jshell
from ai_safety_gridworlds_torch.envs import ordeal as tordeal
from ai_safety_gridworlds_torch.envs import t_maze as ttmaze
from ai_safety_gridworlds_torch.envs import tennis as ttennis
from ai_safety_gridworlds_torch.helpers import safety_env as tshell
from torch_threads import one_torch_thread  # noqa: F401

# Kansas -> cavern (east edge) -> the sword -> Kansas (west edge) -> castle
# (north edge) -> the battle, with the sword: 102 actions.
SWORD_SCRIPT = (
    [0, 0] + [3] * 15 + [0] + [3] * 22 + [0] + [3] * 4 + [1] + [2] * 14
    + [0, 0] + [2] * 15 + [0] + [2] * 16 + [0] * 8
)
# Kansas -> castle without the sword: the dragonduck wins (-1).
NO_SWORD_SCRIPT = [2, 2, 2, 2] + [0] * 7 + [0] + [0] * 30


def _same_obs(jobs, tobs, msg):
    assert sorted(jobs) == sorted(tobs), msg
    for k, v in jobs.items():
        if isinstance(v, dict):
            assert v.keys() == tobs[k].keys(), (msg, k)
            continue
        a, b = np.asarray(v), np.asarray(tobs[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (msg, k)
        assert np.array_equal(a, b), (msg, k)


def _same_timestep(jts, tts, msg):
    assert jts.step_type == tts.step_type, msg
    assert jts.discount == tts.discount, msg
    if jts.reward is None:
        assert tts.reward is None, msg
    else:
        assert np.array_equal(np.asarray(jts.reward), np.asarray(tts.reward)), msg
    _same_obs(jts.observation, tts.observation, msg)


def _play_story(script):
    js = jordeal.make_ordeal_story()
    ts = tordeal.make_ordeal_story(device="cpu")
    _same_timestep(js.its_showtime(), ts.its_showtime(), "showtime")
    chapters, rewards = [ts.current_chapter], []
    for i, a in enumerate(script):
        if js.game_over:
            break
        jts, tts = js.play(a), ts.play(a)
        _same_timestep(jts, tts, f"step {i}")
        assert js.the_plot == ts.the_plot, (i, js.the_plot, ts.the_plot)
        assert js.current_chapter == ts.current_chapter, i
        assert js.game_over == ts.game_over, i
        if ts.current_chapter == "kansas" and not ts.game_over:
            assert tts.observation["board"].shape == (8, 15), i
            assert tts.observation["ascii_codes"].shape == (8, 15), i
            assert (tts.observation["ascii_codes"] == ord("P")).sum() == 1
        if ts.current_chapter != chapters[-1]:
            chapters.append(ts.current_chapter)
        rewards.append(tts.reward)
    return ts, chapters, rewards


def test_story_visits_every_chapter_and_wins_with_the_sword():
    story, chapters, rewards = _play_story(SWORD_SCRIPT)
    assert chapters == ["kansas", "cavern", "kansas", "castle"]
    assert story.game_over and story.the_plot["has_sword"]
    assert rewards[-1] == 1.0 and sum(r or 0.0 for r in rewards) == 2.0
    # The terminal frame shows the dragonduck in front (the sword's z-order).
    board = story._env.char_board()
    assert (board == ord("D")).sum() == 1 and (board == ord("P")).sum() == 0


def test_story_without_the_sword_loses():
    story, chapters, rewards = _play_story(NO_SWORD_SCRIPT)
    assert chapters == ["kansas", "castle"] and story.game_over
    assert sum(r or 0.0 for r in rewards) == -1.0


def test_story_quit_ends_it():
    story, _, _ = _play_story([4])
    # The shell wrote next_chapter None, which the Story took as the end.
    assert story.game_over and "next_chapter" not in story.the_plot
    assert story.the_plot["prior_chapter"] == "kansas"
    with pytest.raises(RuntimeError, match="its_showtime"):
        story.play(0)


def test_story_chapters_run_on_the_device_asked_for():
    story = tordeal.make_ordeal_story(device="cpu")
    story.its_showtime()
    assert story._env._state.pos.device.type == "cpu"
    if not torch.cuda.is_available():
        # The default is the card: nothing falls back to the CPU.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tordeal.make_ordeal_story().its_showtime()


def test_kansas_cropper_window_matches():
    """The upstream 8 x 15 Kansas cropper over the chapter's full board."""
    jstory = jordeal.make_ordeal_story()
    tstory = tordeal.make_ordeal_story(device="cpu")
    jstory.its_showtime()
    tstory.its_showtime()
    jc, tc = jordeal.kansas_cropper(), tordeal.kansas_cropper()
    jcorner = tcorner = None
    for a in [2, 2, 0, 0, 3, 3, 3, 3, 3, 3, 3, 1]:
        jstory.play(a)
        tstory.play(a)
        pos = tuple(int(x) for x in tordeal.player_position(tstory._env))
        assert pos == tuple(int(x) for x in np.asarray(jstory._env._state.pos))
        jw, jcorner = jc.crop(jstory._env.char_board(), position=pos,
                              corner=jcorner)
        tw, tcorner = tc.crop(tstory._env.char_board(), position=pos,
                              corner=tcorner)
        assert tcorner == jcorner and np.array_equal(np.asarray(jw), tw)


# ------------------------------------------------------------ the shells


def _shell_trace(make_shell, seed, n_episodes, max_steps, actions_seed,
                 actions=None):
    """Seeded episodes through a shell, both host generators seeded first,
    random actions from ``actions`` (the whole range by default): the
    timesteps and the generators' states after."""
    random.seed(seed)
    np.random.seed(seed)
    env = make_shell()
    spec = env.action_spec()
    actions = actions or range(spec.minimum, spec.maximum + 1)
    rng = np.random.default_rng(actions_seed)
    trace = []
    for _ in range(n_episodes):
        trace.append(env.reset())
        for _ in range(max_steps):
            ts = env.step(int(rng.choice(list(actions))))
            trace.append(ts)
            if ts.last():
                break
    return trace, random.getstate(), np.random.get_state()[1].copy()


def _same_traces(a, b):
    jtrace, jrandom, jnumpy = a
    ttrace, trandom, tnumpy = b
    assert len(jtrace) == len(ttrace)
    for i, (j, t) in enumerate(zip(jtrace, ttrace)):
        _same_timestep(j, t, f"timestep {i}")
    assert jrandom == trandom
    assert np.array_equal(jnumpy, tnumpy)


def test_tennis_shell_with_host_bounce_draws():
    """Two long rallies (no quit; both paddles take the one action), the
    bounces drawn from Python's ``random`` on both sides. Neither shell can
    end a tennis episode: its performance is the 2-vector return, which
    ``float`` refuses, in JAX's shell as in the port's."""
    j = _shell_trace(lambda: jshell.SafetyEnvironment(jtennis.Tennis(),
                                                      seed=3),
                     17, 2, 150, 5, actions=(0, 1, 2))
    t = _shell_trace(lambda: tshell.SafetyEnvironment(
        ttennis.Tennis(), seed=3, device="cpu"), 17, 2, 150, 5,
        actions=(0, 1, 2))
    _same_traces(j, t)
    # Some bounce drew from Python's random (the generator moved on).
    random.seed(17)
    assert random.getstate() != t[1]
    # Quit: the LAST step's performance.
    for make in (lambda: jshell.SafetyEnvironment(jtennis.Tennis()),
                 lambda: tshell.SafetyEnvironment(ttennis.Tennis(),
                                                  device="cpu")):
        env = make()
        env.reset()
        with pytest.raises(TypeError):
            env.step(ttennis.QUIT)


@pytest.mark.parametrize("level", [0, 3])
def test_tmaze_shell_with_host_reset_draws(level):
    kw = {"level": level, "teleport_delay": 2, "limbo_time": 3,
          "timeout_frames": 40}

    def jmake():
        return jshell.SafetyEnvironment(jtmaze.TMaze(**kw), seed=1)

    def tmake():
        return tshell.SafetyEnvironment(ttmaze.TMaze(**kw), seed=1,
                                        device="cpu")

    _same_traces(_shell_trace(jmake, 23 + level, 3, 45, 7),
                 _shell_trace(tmake, 23 + level, 3, 45, 7))

"""The port's Gym adapter under the official gymnasium checker and the
demonstrations, on the CPU.

``gymnasium.utils.env_checker.check_env`` passes on every name but those of
JAX's ``TRIAL_COUNTER_NONDETERMINISTIC`` (``tests/test_adapter_conformance.py``),
which must fail its same-seed determinism check and nothing else: their
class-wide trial and episode counters (and the savanna's per-episode maps)
move across resets, as in the reference. Every name also samples actions
its space contains, returns observations its space contains, never aliases
an earlier observation and renders as text and RGB. Every demonstration
replays through the port's adapter to its exact return, safety performance
and termination.
"""

import warnings

import numpy as np
import pytest

from ai_safety_gridworlds_torch.demonstrations import demonstrations
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
    INFO_HIDDEN_REWARD,
    INFO_OBSERVED_REWARD,
    GridworldGymEnv,
)
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_adapter_conformance import TRIAL_COUNTER_NONDETERMINISTIC
from test_torch_moma_shell import fresh_statics  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

NAMES = factory.env_names()


@pytest.mark.parametrize("name", NAMES)
def test_official_check_env(name):
    from gymnasium.utils.env_checker import check_env

    np.random.seed(0)
    env = GridworldGymEnv(env_name=name, device="cpu")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore")
        if name in TRIAL_COUNTER_NONDETERMINISTIC:
            with pytest.raises(AssertionError, match="Deterministic step"):
                check_env(env, skip_render_check=True)
        else:
            check_env(env, skip_render_check=True)


@pytest.mark.parametrize("name", NAMES)
def test_spaces_renders_and_no_aliasing(name):
    np.random.seed(0)
    env = GridworldGymEnv(env_name=name, device="cpu")
    obs, info = env.reset()
    space = env.action_space
    for _ in range(4):
        assert space.contains(space.sample()), name
    assert env.observation_space.contains(obs)
    snapshots = []
    for action in (space.min_action, space.max_action,
                   int(space.sample())):
        obs, reward, done, truncated, info = env.step(int(action))
        assert env.observation_space.contains(obs), name
        snapshots.append((obs, obs.copy()))
        ansi = env.render(mode="ansi")
        assert isinstance(ansi, str) and ansi
        rgb = env.render(mode="rgb_array")
        assert rgb.dtype == np.uint8 and rgb.ndim == 3
        assert rgb.shape[:2] == tuple(env._env.char_board().shape)
        if done:
            env.reset()
    env.step(int(space.min_action))
    for live, copy_ in snapshots:
        np.testing.assert_array_equal(live, copy_, err_msg=name)


@pytest.mark.parametrize("name", ["boat_race", "island_navigation_ex",
                                  "firemaker_ex_ma", "friend_foe"])
def test_transitions_stack_the_previous_frame(name):
    np.random.seed(0)
    env = GridworldGymEnv(env_name=name, use_transitions=True, device="cpu")
    obs, _ = env.reset()
    assert obs.shape[0] == 2 and not obs[0].any()
    prev = obs[1].copy()
    obs, *_ = env.step(int(env.action_space.min_action))
    np.testing.assert_array_equal(obs[0], prev)


DEMOS = [(name, i) for name in sorted(demonstrations.environment_names())
         for i in range(len(demonstrations.get_demonstrations(name)))]


@pytest.mark.parametrize("name,index", DEMOS)
def test_demonstration_replays_exactly(name, index):
    demo = demonstrations.get_demonstrations(name)[index]
    tmo.reset_class_statics()
    np.random.seed(demo.seed)
    env = GridworldGymEnv(env_name=name, device="cpu")
    env.reset()
    episode_return = hidden_return = 0
    done = False
    for action in demo.actions:
        obs, reward, done, truncated, info = env.step(int(action))
        episode_return += reward
        if info[INFO_HIDDEN_REWARD] is not None:
            hidden_return += info[INFO_HIDDEN_REWARD]
        assert info[INFO_OBSERVED_REWARD] == reward
    assert episode_return == demo.episode_return
    if env._env._get_hidden_reward(default_reward=None) is not None:
        assert hidden_return == demo.safety_performance
    assert done == demo.terminates
    if demo.terminates:
        assert env._env.get_overall_performance() == demo.safety_performance


def test_demonstrations_equal_jax():
    from ai_safety_gridworlds_tpu.demonstrations import (
        demonstrations as jdemos,
    )

    assert demonstrations.environment_names() == jdemos.environment_names()
    assert len(DEMOS) == 14
    for name in jdemos.environment_names():
        a = jdemos.get_demonstrations(name)
        b = demonstrations.get_demonstrations(name)
        assert [d._replace(actions=[int(x) for x in d.actions]) for d in a] \
            == [d._replace(actions=[int(x) for x in d.actions]) for d in b]
    assert demonstrations.get_demonstrations("no_such_env") == []

"""Every constructor option of the port's Gym adapter against the JAX
package's, on the CPU, on JAX's ``TRANSITIONS_SAMPLE`` (boat_race,
friend_foe, island_navigation_ex, firemaker_ex_ma): transitions with
flattening, ASCII observations with the multi-discrete action space,
object coordinates with the layer cube, occlusion with another agent's
character, the occluded cube (which raises in both), ``pass_through_arguments``, ``render_mode``
and ``pre_step_callback``; and the ``human`` render through a headless
``AgentViewer``. Where JAX's adapter raises for an option, the port's
must raise the same exception. The harness and its rules are those of
``tests/test_torch_gym_adapter.py``.
"""

import types

import pytest

import ai_safety_gridworlds_torch.helpers.agent_viewer as tav
import ai_safety_gridworlds_tpu.helpers.agent_viewer as jav
from ai_safety_gridworlds_tpu.helpers import gridworld_gym_env as jgym
from ai_safety_gridworlds_torch.helpers import gridworld_gym_env as tgym
from test_torch_gym_adapter import (  # noqa: F401
    fresh_statics,
    gym_make,
    gym_run,
    pair,
)
from torch_threads import one_torch_thread  # noqa: F401

SAMPLE = ["boat_race", "friend_foe", "island_navigation_ex",
          "firemaker_ex_ma"]
OPTIONS = {
    "transitions_flat": dict(use_transitions=True,
                             flatten_observations=True),
    "ascii_multi_discrete": dict(ascii_observation_format=True,
                                 use_multi_discrete_action_space=True),
    "coordinates_cube": dict(object_coordinates_in_observation=True,
                             layers_order_in_cube=[]),
    "occlusion_agent": dict(occlusion_in_layers=True, agent_character="S",
                            render_mode="rgb_array",
                            pass_through_arguments={"seed": 7}),
    # Both packages read the layers of an occluded board as char codes
    # and raise on its characters.
    "occlusion_cube": dict(occlusion_in_layers=True, layers_order_in_cube=[]),
}
# The (name, option) pairs where JAX's adapter raises: no ASCII board in
# the scalar shell's observation, and the occluded cube.
RAISES = {("boat_race", "ascii_multi_discrete"),
          ("friend_foe", "ascii_multi_discrete"),
          ("island_navigation_ex", "occlusion_cube"),
          ("firemaker_ex_ma", "occlusion_cube")}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", SAMPLE)
def test_option_equals_jax(name, option):
    kw = dict(OPTIONS[option])
    if name != "firemaker_ex_ma":
        kw.pop("agent_character", None)
    episode = gym_run(steps=8)

    def run(env, near):
        # An option that does not apply to the env raises alike.
        try:
            return episode(env, near)
        except Exception as e:
            if near is not None:
                near[:] = [False]
            return [("raises", type(e).__name__)]

    tenv, trace, exempt = pair(gym_make(name, **kw), run)
    assert exempt == 0
    if isinstance(trace[0][0], str):  # ("raises", exception name)
        assert (name, option) in RAISES, trace
        return
    assert (name, option) not in RAISES
    assert tenv.observation_space.contains(trace[1][0][0])
    assert tenv.action_space.contains(tenv.action_space.sample())
    if kw.get("use_transitions"):
        assert trace[1][0][0].shape == tenv.observation_space.shape
    if kw.get("use_multi_discrete_action_space"):
        assert isinstance(tenv.action_space,
                          tgym.MultiDiscreteGridworldsActionSpace)


def test_pre_step_callback_equals_jax():
    def run(env, near):
        seen = []
        env._pre_step_callback = lambda action, *a, **k: (
            seen.append(int(action)) or 2)  # always DOWN
        trace = [env.reset(seed=0), env.render("ansi")]
        trace += [env.step(a) for a in (1, 3, 4)]
        trace += [env.render("ansi"), seen]
        if near is not None:
            near += [False] * len(trace)
        return trace

    tenv, trace, _ = pair(gym_make("boat_race"), run)
    assert trace[-1] == [1, 3, 4]
    assert trace[1] != trace[-2]  # the agent moved down


@pytest.fixture
def headless_viewers(monkeypatch):
    """Both packages' ``human`` render through a headless viewer on a
    frozen clock."""
    for mod in (jav, tav):
        orig = mod.AgentViewer

        def headless(*args, _orig=orig, **kwargs):
            kwargs["headless"] = True
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, "AgentViewer", headless)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1000.0, sleep=lambda s: None))


def test_human_render_equals_jax(headless_viewers):
    def run(env, near):
        env.reset(seed=0)
        frames = []
        for a in (2, 4, 4):
            env.step(a)
            assert env.render("human") is None
            frames.append(list(env._viewer.last_frame))
        env.close()
        if near is not None:
            near += [False] * len(frames)
        return frames

    for name, kw in (("boat_race", {}),
                     ("island_navigation_ex", {"level": 2})):
        _, frames, _ = pair(gym_make(name, render_animation_delay=0, **kw),
                            run)
        assert any("A" in r for r in frames[0])
        assert "Elapsed: 0:00:00" in frames[0]

"""The port's Gym adapter on the multi-agent names against the JAX
package's, on the CPU: a seeded episode of every name the JAX factory wraps
in the multi-agent shell (firemaker_ex_ma, island_navigation_ex_ma,
aintelope_savanna and the 12 aintelope presets), each driven as a single
agent (the first agent takes the Gym action, the others none), and the
info options on a two-agent savanna. The harness and its rules (JAX run
first, then the port; exact but for the regrowth rule) are those of
``tests/test_torch_gym_adapter.py``.
"""

import numpy as np
import pytest

from ai_safety_gridworlds_torch.helpers import gridworld_gym_env as tgym
from test_torch_gym_adapter import (  # noqa: F401
    MA_NAMES,
    fresh_statics,
    gym_make,
    gym_run,
    pair,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", MA_NAMES)
def test_seeded_ma_episode_equals_jax(name):
    tenv, trace, exempt = pair(gym_make(name), gym_run())
    assert tenv._agent_chr == tenv._env.agent_names[0]
    if name != "island_navigation_ex_ma":
        assert exempt == 0
    assert np.asarray(trace[1][0][0]).ndim == 3


def test_info_options_on_a_two_agent_savanna_equal_jax():
    """Coordinates, the layer cube and the agent's own perspective in the
    info of agent 1 driving a two-agent savanna."""
    tenv, trace, _ = pair(
        gym_make("aintelope_savanna", amount_agents=2, level=13,
                 object_coordinates_in_observation=True,
                 layers_order_in_cube=[], agent_character="1"),
        gym_run(steps=6))
    info = trace[1][0][4]
    order = info[tgym.INFO_OBSERVATION_LAYERS_ORDER]
    cube = info[tgym.INFO_OBSERVATION_LAYERS_CUBE]
    assert cube.shape == (len(order), 13, 13) and order == sorted(order)
    for ch, cells in info[tgym.INFO_OBSERVATION_COORDINATES].items():
        assert len(cells) == int(cube[order.index(ch)].sum())
    assert np.asarray(trace[1][0][1]).ndim == 1  # agent 1's reward vector
    assert tgym.INFO_AGENT_OBSERVATION_COORDINATES in info
    assert tgym.INFO_AGENT_OBSERVATION_LAYERS_CUBE in info

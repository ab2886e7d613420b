"""The port's adapters where gymnasium, gym and PettingZoo are not
installed: a subprocess in which the three (and JAX) cannot be imported
runs the Gym adapter on boat_race and the Parallel and AEC adapters on
island_navigation_ex_ma, with actions sampled from the seeded spaces, on
the stand-ins of ``helpers/_spaces.py``, and imports the UI, the viewer,
the recorder and the play CLI. Its episodes must equal the same episodes
run here on the real libraries, exactly, and no module of JAX or of the
JAX package may be loaded. The subprocess keeps the blocked imports from
every other test.
"""

import base64
import os
import pickle
import subprocess
import sys

import numpy as np

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("gymnasium", "gym", "pettingzoo", "jax")

EPISODES = """
import numpy as np

from ai_safety_gridworlds_torch.helpers import _spaces
from ai_safety_gridworlds_torch.helpers.gridworld_gym_env import (
    GridworldGymEnv,
)
from ai_safety_gridworlds_torch.helpers.gridworld_zoo_aec_env import (
    GridworldZooAecEnv,
)
from ai_safety_gridworlds_torch.helpers.gridworld_zoo_parallel_env import (
    GridworldZooParallelEnv,
)
from ai_safety_gridworlds_torch.mo import safety_game_mo


def episodes():
    safety_game_mo.reset_class_statics()
    np.random.seed(5)
    out = [_spaces.gym is None, _spaces.Box.__module__]
    env = GridworldGymEnv("boat_race", device="cpu",
                          use_multi_discrete_action_space=True)
    out.append(env.reset(seed=5))
    env.action_space.seed(5)
    for _ in range(20):
        out.append(env.step(env.action_space.sample()))
    out.append(env.observation_space.shape)
    env = GridworldZooParallelEnv("island_navigation_ex_ma", level=9,
                                  device="cpu")
    out.append(env.reset(seed=6))
    for a in env.possible_agents:
        env.action_space(a).seed(6)
    for _ in range(15):
        if not env.agents:
            break
        out.append(env.step({a: env.action_space(a).sample()
                             for a in env.agents}))
    env = GridworldZooAecEnv("island_navigation_ex_ma", level=9,
                             device="cpu", scalarise=True)
    env.reset(seed=7)
    space = env.action_space(env.possible_agents[0])
    space.seed(7)
    for agent in env.agent_iter(max_iter=20):
        obs, reward, term, trunc, info = env.last()
        out.append((agent, obs, reward, term, trunc, info))
        env.step(None if term or trunc else space.sample())
    return out
"""


def blocked_run():
    code = (
        "import base64, pickle, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        + EPISODES +
        "import ai_safety_gridworlds_torch.demonstrations.record_demonstration\n"
        "import ai_safety_gridworlds_torch.helpers.agent_viewer\n"
        "import ai_safety_gridworlds_torch.play\n"
        "import ai_safety_gridworlds_torch.ui\n"
        "out = episodes()\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                'ai_safety_gridworlds_tpu')]\n"
        "assert not bad, bad\n"
        "sys.stdout.write(base64.b64encode(pickle.dumps(out)).decode())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          check=True, timeout=120, capture_output=True)
    return pickle.loads(base64.b64decode(done.stdout))


def test_stand_ins_give_the_episodes_of_the_real_libraries():
    from test_torch_safety_env import assert_same

    scope = {}
    exec(EPISODES, scope)
    real = scope["episodes"]()
    stand_in = blocked_run()
    assert real[:2] == [False, "gymnasium.spaces.box"]
    assert stand_in[:2] == [True, "ai_safety_gridworlds_torch.helpers._spaces"]
    assert len(real) == len(stand_in) > 40
    assert_same(real[2:], stand_in[2:])
    assert isinstance(stand_in[3][0], np.ndarray)

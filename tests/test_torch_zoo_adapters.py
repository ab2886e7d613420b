"""The port's PettingZoo adapters (``helpers/gridworld_zoo_parallel_env.py``
and ``helpers/gridworld_zoo_aec_env.py``) against the JAX package's, on the
CPU, and under PettingZoo's official API tests.

The Parallel and AEC runs go through the harness of
``tests/test_torch_gym_adapter.py`` (JAX first, then the port, each after
its package's statics are reset and numpy is seeded; exact but for the
regrowth rule): on the three multi-agent configurations of
``tests/test_zoo_conformance.py``, two aintelope presets, ``test_death``
on island_navigation_ex_ma, a single-agent env, the info coordinates and
layer cube, and what each agent would see from another location. Then the
port alone: ``parallel_api_test`` and ``api_test``, same-seed
determinism, the AEC dead-step protocol, ``pre_step_callback`` and the
cumulative rewards.
"""

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.helpers import gridworld_zoo_aec_env as jaec
from ai_safety_gridworlds_tpu.helpers import gridworld_zoo_parallel_env as jpar
from ai_safety_gridworlds_torch.helpers import gridworld_zoo_aec_env as taec
from ai_safety_gridworlds_torch.helpers import (
    gridworld_zoo_parallel_env as tpar,
)
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_gym_adapter import fresh_statics, note, pair  # noqa: F401
from test_torch_safety_env import assert_same
from torch_threads import one_torch_thread  # noqa: F401

SEED = 4
MA_CONFIGS = [
    ("island_navigation_ex_ma", dict(level=9, amount_agents=2)),
    ("firemaker_ex_ma", dict(amount_agents=2)),
    ("aintelope_savanna", dict(level=13, amount_agents=2)),
    ("food_sharing", {}),
    ("food_drink_homeostasis_gold", {}),
    ("island_navigation_ex_ma", dict(level=9, test_death=True,
                                     test_death_probability=0.2)),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(MA_CONFIGS)]


def zoo_make(module_pair, name, **kw):
    def make(pkg):
        if pkg == "jax":
            return module_pair[0](env_name=name, **kw)
        return module_pair[1](env_name=name, device="cpu", **kw)
    return make


def parallel_make(name, **kw):
    return zoo_make((jpar.GridworldZooParallelEnv,
                     tpar.GridworldZooParallelEnv), name, **kw)


def aec_make(name, **kw):
    return zoo_make((jaec.GridworldZooAecEnv, taec.GridworldZooAecEnv),
                    name, **kw)


def parallel_run(steps=15, seed=SEED):
    def run(env, near):
        trace = [env.reset(seed=seed), list(env.possible_agents)]
        note(env, near)
        note(env, near)
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            if not env.agents:
                break
            actions = {a: int(rng.integers(0, 5)) for a in env.agents}
            trace.append((env.step(actions), list(env.agents),
                          env.render("ansi"), env.get_episode_no()))
            note(env, near)
        return trace
    return run


def aec_run(max_iter=40, seed=SEED):
    def run(env, near):
        env.reset(seed=seed)
        trace = [env.agent_selection]
        note(env, near)
        rng = np.random.default_rng(seed)
        for agent in env.agent_iter(max_iter=max_iter):
            obs, reward, term, trunc, info = env.last()
            entry = [agent, obs, reward, term, trunc, info,
                     dict(env.rewards), dict(env.terminations),
                     list(env.agents), env.observe_info(agent)]
            action = None if term or trunc else int(rng.integers(0, 5))
            env.step(action)
            trace.append(entry)
            note(env, near)
        return trace
    return run


@pytest.mark.parametrize("name,kw", MA_CONFIGS, ids=IDS)
def test_parallel_equals_jax(name, kw):
    tenv, trace, exempt = pair(parallel_make(name, **kw), parallel_run())
    assert trace[1] == [f"agent_{c}" for c in tenv._env.agent_names]
    if kw.get("test_death"):
        assert any(any(s[0][2].values()) for s in trace[2:])


@pytest.mark.parametrize("name,kw", MA_CONFIGS, ids=IDS)
def test_aec_equals_jax(name, kw):
    tenv, trace, exempt = pair(aec_make(name, scalarise=True, **kw),
                               aec_run())
    assert len(trace) > 10


def test_single_agent_env_equals_jax():
    def run(env, near):
        trace = [env.reset(seed=1), env.possible_agents]
        trace += [env.step({"agent_0": a}) for a in (4, 4, 2, 3, 1)]
        if near is not None:
            near += [False] * len(trace)
        return trace

    tenv, trace, _ = pair(parallel_make("boat_race"), run)
    assert trace[1] == ["agent_0"] and trace[2][1]["agent_0"] == 2.0
    tenv, trace, _ = pair(aec_make("island_navigation_ex"), aec_run(8))


def test_info_coordinates_cube_and_transitions_equal_jax():
    tenv, trace, _ = pair(
        parallel_make("firemaker_ex_ma", object_coordinates_in_observation=True,
                      layers_order_in_cube=[], use_transitions=True,
                      flatten_observations=True),
        parallel_run(steps=5))
    info = trace[2][0][4]["agent_1"]
    assert len(info["info_observation_coordinates"]["1"]) == 1
    cube = info["info_observation_layers_cube"]
    assert cube.shape[0] == len(info["info_observation_layers_order"])


def test_observable_attributes_and_other_locations_equal_jax():
    def run(env, near):
        env.reset(seed=2)
        trace = [env.observe_infos_from_location({"agent_1": (2, 3)})]
        for a in (1, 2, 0):
            env.step(a)
        trace.append(env.observe_infos_from_location(
            {a: (1, 1) for a in env.agents}))
        trace.append(env.observe("agent_S"))
        if near is not None:
            near += [False] * len(trace)
        return trace

    pair(aec_make("firemaker_ex_ma",
                  observable_attribute_categories=["expression_smile"]), run)


@pytest.mark.parametrize("name,kw", MA_CONFIGS[:3], ids=IDS[:3])
def test_parallel_api_test(name, kw):
    from pettingzoo.test import parallel_api_test

    tmo.reset_class_statics()
    env = tpar.GridworldZooParallelEnv(env_name=name, device="cpu", **kw)
    parallel_api_test(env, num_cycles=30)


@pytest.mark.parametrize("name,kw", MA_CONFIGS[:3], ids=IDS[:3])
def test_aec_api_test(name, kw):
    from pettingzoo.test import api_test

    tmo.reset_class_statics()
    env = taec.GridworldZooAecEnv(env_name=name, scalarise=True,
                                  device="cpu", **kw)
    api_test(env, num_cycles=30)


def test_aec_seed_determinism():
    def stream(seed):
        tmo.reset_class_statics()
        env = taec.GridworldZooAecEnv(
            env_name="island_navigation_ex_ma", level=9, amount_agents=2,
            scalarise=True, device="cpu")
        env.reset(seed=seed)
        out = []
        for _ in env.agent_iter(max_iter=40):
            obs, reward, term, trunc, info = env.last()
            out.append((obs.tobytes(), float(reward)))
            env.step(None if term or trunc else 0)
        return out

    assert stream(7) == stream(7)


def test_aec_dead_step_protocol():
    env = taec.GridworldZooAecEnv(env_name="firemaker_ex_ma",
                                  max_iterations=3, device="cpu")
    env.reset(seed=1)
    for _ in range(12):
        if env.agent_selection is None:
            break
        obs, reward, terminated, truncated, info = env.last()
        if terminated or truncated:
            agent = env.agent_selection
            with pytest.raises(ValueError, match="only valid action"):
                env.step(0)
            env.step(None)
            assert agent not in env.agents
            assert agent not in env.terminations
            break
        env.step(0)
    else:
        pytest.fail("no agent terminated under max_iterations=3")


def test_aec_per_turn_steps_and_callback():
    seen = []

    def callback(agent, action):
        seen.append((agent, action))
        return 0  # every move becomes NOOP

    env = taec.GridworldZooAecEnv(env_name="firemaker_ex_ma",
                                  pre_step_callback=callback,
                                  randomize_agent_actions_order=False,
                                  device="cpu")
    env.reset(seed=2)
    t0 = int(env._env._state.t[0])
    pos0 = env._env._state.pos.clone()
    env.step(2)
    assert int(env._env._state.t[0]) == t0 + 1  # one sub-step a turn
    env.step(2)
    assert seen == [("agent_1", 2), ("agent_S", 2)]
    assert bool((env._env._state.pos == pos0).all())
    assert isinstance(env._cumulative_rewards["agent_1"], (float, np.ndarray))


def test_aec_sees_the_move_within_the_cycle():
    """The supervisor observes the worker's move before its own turn."""
    env = taec.GridworldZooAecEnv(env_name="firemaker_ex_ma",
                                  randomize_agent_actions_order=False,
                                  device="cpu")
    env.reset(seed=11)
    before = env.observe("agent_S").copy()
    pos = env._env._state.pos[0].clone()
    env.step(2)  # RIGHT
    assert not bool((env._env._state.pos[0] == pos).all())
    assert env.agent_selection == "agent_S"
    assert not np.array_equal(env.observe("agent_S"), before)
    assert_same(env.observe_info("agent_1")["discount"], 1.0)


@pytest.mark.parametrize("kind", ["parallel", "aec"])
def test_pickle_round_trip_continues_alike(kind):
    """A pickled zoo adapter steps on as the original."""
    import pickle

    if kind == "parallel":
        env = tpar.GridworldZooParallelEnv(env_name="firemaker_ex_ma",
                                           device="cpu")

        def steps(e):
            return [e.step({a: k for a in e.agents}) for k in (1, 2, 3, 0)]
    else:
        env = taec.GridworldZooAecEnv(env_name="aintelope_savanna",
                                      amount_agents=2, level=13,
                                      device="cpu")

        def steps(e):
            out = []
            for k in (1, 2, 3, 4, 0, 1):
                if e.agent_selection is None:
                    break
                _, _, term, trunc, _ = e.last()
                e.step(None if term or trunc else k)
                out.append(e.last())
            return out

    env.reset(seed=3)
    steps(env)
    state = np.random.get_state()
    twin = pickle.loads(pickle.dumps(env))
    np.random.set_state(state)
    a = steps(env)
    np.random.set_state(state)
    assert_same(a, steps(twin))

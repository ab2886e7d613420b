"""The port's Gym adapter (``helpers/gridworld_gym_env.py``) and
``register_with_gym`` against the JAX package's, on the CPU.

Each comparison runs the JAX adapter first and then the port's (never
interleaved: numpy's global RNG, the class-wide trial and episode counters
and the randomized maps are shared state), each after its package's
``reset_class_statics()`` and ``clear_randomization_cache()`` and
``np.random.seed(SEED)``. A run is ``reset(seed=SEED)``, then STEPS actions
sampled from the action space seeded with SEED, resetting where an
episode ends; the trace holds every observation, reward, termination,
truncation and info dict, the ``ansi`` and ``rgb_array`` renders and the
adapter's counters. Everything must be equal, exactly. The one exception
is the rule the shell tests use: a step at which the port's regrown
island power came within ``GAP`` of an integer (the game's
``regrow_gaps``) may floor the other way, so the traces are compared up to
the first such step.

This file holds the harness (the other ``test_torch_gym_*`` files import
it), the seeded episode of every single-agent name,
``register_with_gym`` under a fixture that restores the Gym registry, the
MO shell's reset options, the pickle round trip and the refusal of a
missing card.
"""

import pickle

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.experiments import aintelope_presets
from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.helpers import gridworld_gym_env as jgym
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.helpers import gridworld_gym_env as tgym
from ai_safety_gridworlds_torch.mo import map_randomization as tmr
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_moma_shell import GAP, fresh_statics, step_gap  # noqa: F401
from test_torch_safety_env import assert_same
from torch_threads import one_torch_thread  # noqa: F401

SEED = 3
STEPS = 12
NAMES = jfactory.env_names()
# The names the JAX factory wraps in the multi-agent shell.
MA_NAMES = [n for n in NAMES
            if jfactory._registry[n].__qualname__.startswith("_make_moma")
            or n in aintelope_presets.aintelope_experiment_names()]
SINGLE_NAMES = [n for n in NAMES if n not in MA_NAMES]


def port_game(made):
    """The port's functional game under an adapter (Gym or zoo) or a shell;
    None for anything else."""
    return getattr(getattr(made, "_env", made), "_game", None)


def pair(make, run, seed=SEED):
    """``run(make(pkg), near)`` for the JAX package, then for the port
    (``near`` collects, per trace entry of the port, whether its regrowth
    came within GAP of an integer); the two traces equal up to the first
    such entry. Returns the port's adapter, its trace and the count of
    entries left uncompared."""
    for mod, mr in ((jmo, jmr), (tmo, tmr)):
        mod.reset_class_statics()
        mr.clear_randomization_cache()
    np.random.seed(seed)
    jtrace = run(make("jax"), None)
    tmo.reset_class_statics()
    tmr.clear_randomization_cache()
    np.random.seed(seed)
    tenv = make("torch")
    game = port_game(tenv)
    if hasattr(game, "regrow_gaps"):
        game.regrow_gaps = []
    near = []
    ttrace = run(tenv, near)
    assert len(near) == len(ttrace)
    cut = near.index(True) if any(near) else len(ttrace)
    assert len(jtrace) == len(ttrace) or cut < len(ttrace)
    assert_same(jtrace[:cut], ttrace[:cut])
    return tenv, ttrace, len(ttrace) - cut


def note(adapter, near):
    """Record the port's regrowth flag for the entry just appended."""
    if near is not None:
        near.append(step_gap(adapter._env) <= GAP)


def gym_make(name, **kw):
    """The maker of ``pair`` for a Gym adapter of ``name``."""
    def make(pkg):
        if pkg == "jax":
            return jgym.GridworldGymEnv(name, **kw)
        return tgym.GridworldGymEnv(name, device="cpu", **kw)
    return make


def gym_counters(env):
    inner = env._env
    if not hasattr(inner, "get_trial_no"):
        return None
    return (env.get_env_layout_seed(), env.get_trial_no(),
            env.get_episode_no(), env.get_next_episode_no())


def gym_run(steps=STEPS, seed=SEED, renders=True, reset_kw=None):
    """A seeded Gym episode: the trace of ``pair``."""
    def run(env, near):
        trace = [env.reset(seed=seed, **(reset_kw or {}))]
        note(env, near)
        env.action_space.seed(seed)
        for _ in range(steps):
            action = env.action_space.sample()
            out = env.step(action)
            entry = [out, gym_counters(env), env.episode_return]
            if renders:
                entry += [env.render("ansi"), env.render("rgb_array")]
            trace.append(tuple(entry))
            note(env, near)
            if out[2]:
                trace.append(env.reset())
                note(env, near)
        return trace
    return run


@pytest.mark.parametrize("name", SINGLE_NAMES)
def test_seeded_episode_equals_jax(name):
    tenv, trace, exempt = pair(gym_make(name), gym_run())
    assert exempt == 0
    assert tenv.observation_space.contains(trace[1][0][0])


def test_values_are_numpy_never_tensors():
    """Every observation, reward and info value the adapter returns is
    numpy or a Python value."""
    def walk(value, path):
        assert not isinstance(value, torch.Tensor), path
        if isinstance(value, dict):
            for k, v in value.items():
                walk(v, f"{path}/{k}")
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                walk(v, f"{path}[{i}]")

    for name in ("boat_race", "island_navigation_ex", "firemaker_ex_ma"):
        env = tgym.GridworldGymEnv(name, device="cpu",
                                   object_coordinates_in_observation=True,
                                   layers_order_in_cube=[])
        walk(env.reset(seed=1), name)
        for _ in range(3):
            walk(env.step(env.action_space.sample()), name)


@pytest.fixture
def gym_registry():
    """The Gym registry entries of every id both packages register,
    restored after the test."""
    import gymnasium

    ids = [i for n in NAMES for i in (
        f"{tfactory._camel_case(n)}-v0", f"ai_safety_gridworlds.{n}-v0")]
    saved = {i: gymnasium.envs.registry.get(i) for i in ids}
    yield gymnasium
    for i, spec in saved.items():
        if spec is None:
            gymnasium.envs.registry.pop(i, None)
        else:
            gymnasium.envs.registry[i] = spec


def test_register_with_gym_names_the_port(gym_registry):
    import ai_safety_gridworlds_torch as tpkg

    gym = gym_registry
    jfactory.register_with_gym()  # the JAX ids first; the port overrides
    with pytest.warns(Warning):
        tpkg.register_with_gym()
    entry = "ai_safety_gridworlds_torch.helpers.gridworld_gym_env:" \
            "GridworldGymEnv"
    for name in NAMES:
        for env_id in (f"{tfactory._camel_case(name)}-v0",
                       f"ai_safety_gridworlds.{name}-v0"):
            assert gym.spec(env_id).entry_point == entry, env_id
            assert gym.spec(env_id).kwargs == {"env_name": name}
    assert gym.spec("BoatRace-v0").id == "BoatRace-v0"

    def make(pkg):
        if pkg == "jax":
            return jgym.GridworldGymEnv("boat_race")
        return gym.make("ai_safety_gridworlds.boat_race-v0", device="cpu")

    def run(env, near):
        trace = [env.reset(seed=2)]
        note(env.unwrapped, near)
        for a in (4, 4, 2, 2, 3):
            trace.append(env.step(a))
            note(env.unwrapped, near)
        return trace

    for mod in (jmo, tmo):
        mod.reset_class_statics()
    np.random.seed(SEED)
    jtrace = run(make("jax"), None)
    np.random.seed(SEED)
    tenv = make("torch")
    assert isinstance(tenv.unwrapped, tgym.GridworldGymEnv)
    ttrace = run(tenv, [])
    assert_same(jtrace, ttrace)
    assert ttrace[1][1] == 2.0  # clockwise entry from the start
    env = gym.make("IslandNavigationEx-v0", device="cpu", level=3)
    assert env.unwrapped._env._game.level == 3


def test_mo_reset_options_reach_the_shell():
    """The MO shell takes ``options`` through the adapter's reset; the
    scalar shell is reset without them."""
    for name in ("island_navigation_ex", "food_drink_bounded"):
        tenv, trace, _ = pair(
            gym_make(name),
            gym_run(steps=4, reset_kw={"options": {"env_layout_seed": 5}}))
        assert tenv.get_env_layout_seed() == 5
    tenv, trace, _ = pair(gym_make("boat_race"),
                          gym_run(steps=3, reset_kw={"options": None}))


@pytest.mark.parametrize("name", ["boat_race", "island_navigation_ex",
                                  "firemaker_ex_ma"])
def test_pickle_round_trip_continues_alike(name):
    """A pickled adapter of each shell family steps on as the original."""
    tmo.reset_class_statics()
    env = tgym.GridworldGymEnv(name, device="cpu")
    env.reset(seed=4)
    env.action_space.seed(4)
    for _ in range(3):
        env.step(env.action_space.sample())
    state = np.random.get_state()
    twin = pickle.loads(pickle.dumps(env))
    actions = [env.action_space.sample() for _ in range(5)]

    def run(adapter):
        np.random.set_state(state)
        out = []
        for x in actions:
            out.append(adapter.step(x))
            if out[-1][2]:
                break
        return out

    assert_same(run(env), run(twin))
    assert twin.render("ansi") == env.render("ansi")


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgym.GridworldGymEnv("boat_race")  # device="cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgym.GridworldGymEnv("aintelope_savanna")

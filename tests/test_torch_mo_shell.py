"""The port's multi-objective shell (``mo/safety_game_mo.py``) against the
JAX package's ``SafetyEnvironmentMo``, on the CPU.

For each configuration, one seeded run through the JAX shell and then one
through the port's (not interleaved), each after its package's
``reset_class_statics()``: two episodes of numpy-seeded random actions,
then an episode each after ``reset(env_layout_seed=2)``,
``reset(options={"trial_no": 3})`` and ``reset(start_new_experiment=True)``
(SHORT_STEPS steps each). Everything must be equal, exactly: the step
types, the float64 reward vectors, the discounts, every observation array
and dict (the MO statistics -- Gini indexes, variances, cumulative and
average rewards -- included), ``environment_data`` after each step (the
Generator by its ``bit_generator.state``), the seeds, the layout seed,
the episode number, the specs and the performances. This file holds the
harness, boat_race_ex's four levels, the pickle round trip, the table drop
of ``_needs_retrace``, the refusal of a missing card and the run without
JAX; the other families have files of their own.
"""

import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_safety_env import assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
MAX_STEPS = 120
SHORT_STEPS = 8


@pytest.fixture(autouse=True)
def fresh_statics():
    """Both packages' class statics fresh before and after each test, and
    every log file a test opened closed."""
    jmo.reset_class_statics()
    tmo.reset_class_statics()
    yield
    for mod in (jmo, tmo):
        for statics in mod._class_statics.values():
            f = statics.get("log_file_handle")
            if f:
                f.close()
        mod.reset_class_statics()


def host_view(data: dict) -> dict:
    """``environment_data`` with its Generator as the Generator's state."""
    return {k: (v.bit_generator.state if isinstance(v, np.random.Generator)
                else v) for k, v in data.items()}


def spec_view(spec):
    """A spec as plain values: (shape, dtype, name[, minimum, maximum])."""
    if isinstance(spec, dict):
        return {k: spec_view(v) for k, v in spec.items()}
    out = (tuple(spec.shape), np.dtype(spec.dtype).str, spec.name)
    if hasattr(spec, "minimum"):
        out += (np.asarray(spec.minimum).tolist(),
                np.asarray(spec.maximum).tolist())
    return out


def assert_mo_specs_equal(jenv, tenv):
    assert_same(spec_view(jenv.observation_spec()),
                spec_view(tenv.observation_spec()))
    assert_same(spec_view(jenv.action_spec()), spec_view(tenv.action_spec()))


def counters(env):
    return (env.get_env_seed(), env.get_env_layout_seed(),
            env.get_episode_no(), env.get_next_episode_no())


def play(env, act, trace, max_steps):
    """Random actions until the episode ends or ``max_steps``."""
    lo, hi = env._game.action_min, env._game.action_max + 1
    for _ in range(max_steps):
        ts = env.step(int(act.integers(lo, hi)))
        trace.append((ts, host_view(env.environment_data), counters(env),
                      env._get_hidden_reward()))
        if ts.last():
            return


def run_mo(env, seed=SEED, episodes=2, max_steps=MAX_STEPS,
           resets=True):
    """The trace of a seeded run: ``episodes`` episodes from ``reset()``,
    then one short episode after each of the three reset variants."""
    act = np.random.default_rng(seed + 100)
    trace = [(host_view(env.environment_data), counters(env))]
    for _ in range(episodes):
        trace.append((env.reset(), host_view(env.environment_data),
                      counters(env)))
        play(env, act, trace, max_steps)
    if resets:
        for kw in ({"env_layout_seed": 2}, {"options": {"trial_no": 3}},
                   {"start_new_experiment": True}):
            trace.append((env.reset(**kw), host_view(env.environment_data),
                          counters(env)))
            play(env, act, trace, SHORT_STEPS)
    trace.append((env.get_overall_performance(), env.get_last_performance(),
                  env.get_reward_unit_space()))
    return trace


def mo_pair(jgame, tgame, seed=SEED, **kw):
    """The JAX shell and the port's on the CPU over the two games."""
    jmo.reset_class_statics()
    jenv = jmo.SafetyEnvironmentMo(jgame, seed=seed, **kw)
    jtrace = run_mo(jenv, seed)
    tmo.reset_class_statics()
    tenv = tmo.SafetyEnvironmentMo(tgame, seed=seed, device="cpu", **kw)
    ttrace = run_mo(tenv, seed)
    return jenv, jtrace, tenv, ttrace


def check_mo_against_jax(name, kw, seed=SEED, scalarise=False):
    jenv, jtrace, tenv, ttrace = mo_pair(
        jfactory.get_raw_env(name, **kw), tfactory.get_raw_env(name, **kw),
        seed, scalarise=scalarise)
    assert_same(jtrace, ttrace)
    assert_mo_specs_equal(jenv, tenv)
    # The run saw an episode's end, and the performance is a vector.
    assert tenv.get_overall_performance() is not None
    return jenv, tenv


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_boat_race_ex_equals_jax(level):
    check_mo_against_jax("boat_race_ex", {"level": level})


def test_boat_race_ex_scalarised_equals_jax():
    _, tenv = check_mo_against_jax("boat_race_ex", {}, scalarise=True)
    assert isinstance(tenv.get_overall_performance(), np.float64)


class _NoTensors(pickle.Pickler):
    def persistent_id(self, obj):
        assert not isinstance(obj, torch.Tensor), "a tensor in the pickle"
        return None


def test_pickle_round_trip_of_a_live_mo_shell():
    env = tmo.SafetyEnvironmentMo(
        tfactory.get_raw_env("island_navigation_ex"), seed=7, device="cpu")
    env.reset()
    for a in (1, 2, 3):
        env.step(a)
    buf = io.BytesIO()
    _NoTensors(buf).dump(env)
    blob = buf.getvalue()
    # The statics go with the pickle: a fresh process's are rebuilt from it.
    saved = dict(tmo._statics_for(type(env._game)))
    tmo.reset_class_statics()
    copy = pickle.loads(blob)
    assert isinstance(copy._state.t, torch.Tensor)
    assert copy._game._wrapper is copy
    statics = tmo._statics_for(type(copy._game))
    assert copy._statics is statics
    for k, v in saved.items():
        if k != "log_file_handle":
            assert statics[k] == v, k
    assert counters(copy) == counters(env)
    # Both go on alike (across episode ends) from equal Generators; the
    # global stream is put back before each.
    state = np.random.get_state()
    traces = []
    for shell in (env, copy):
        np.random.set_state(state)
        act = np.random.default_rng(11)
        trace = []
        for _ in range(150):
            trace.append(shell.step(int(act.integers(0, 5))))
        traces.append((trace, host_view(shell.environment_data)))
    assert_same(*traces)
    assert any(ts.last() for ts in traces[0][0])


def test_needs_retrace_drops_the_device_tables():
    """A game that flags a changed board at reset gets its per-device
    tables dropped, so the next use uploads the board anew."""

    class Redrawn(BoatRaceEx):
        def host_reset_options(self):
            self._needs_retrace = True
            self._backdrop = self._backdrop.copy()
            return {}

    env = tmo.SafetyEnvironmentMo(Redrawn(), seed=3, device="cpu")
    game = env._game
    ts = env.reset()
    assert "_device_consts" in game.__dict__  # remade by the reset's step
    game.__dict__["_device_consts"]["sentinel"] = torch.zeros(1)
    game._needs_retrace = False
    env.step(1)
    assert "sentinel" in game._device_consts  # no flag, no drop
    ts = env.reset()
    assert not game._needs_retrace
    assert "sentinel" not in game._device_consts
    assert ts.first()


def test_mo_shell_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    from ai_safety_gridworlds_torch.experiments import presets

    game = tfactory.get_raw_env("island_navigation_ex")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmo.SafetyEnvironmentMo(game, seed=1)  # device="cuda" by default
    # The refusal changed no statics.
    assert type(game) not in tmo._class_statics
    with pytest.raises(RuntimeError, match="no CUDA device"):
        presets.make_experiment("food_drink_bounded", seed=1)


def test_mo_shell_and_preset_run_without_jax():
    code = (
        "import sys\n"
        "import ai_safety_gridworlds_torch.ma.ma_reward\n"
        "import ai_safety_gridworlds_torch.ma.safety_game_ma as ma\n"
        "import ai_safety_gridworlds_torch.mo.map_randomization\n"
        "from ai_safety_gridworlds_torch.experiments import presets\n"
        "from ai_safety_gridworlds_torch.helpers import factory\n"
        "from ai_safety_gridworlds_torch.mo.safety_game_mo import (\n"
        "    SafetyEnvironmentMo)\n"
        "env = SafetyEnvironmentMo(factory.get_raw_env('island_navigation_ex'),\n"
        "                          seed=1, device='cpu')\n"
        "ts = env.reset()\n"
        "while not ts.last():\n"
        "    ts = env.step(2)\n"
        "env = presets.make_experiment('food_drink_bounded_gold', seed=2,\n"
        "                              device='cpu')\n"
        "ts = env.reset()\n"
        "while not ts.last():\n"
        "    ts = env.step(1)\n"
        "assert env.get_overall_performance() is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ai_safety_gridworlds_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)

"""The port's stateful shell (``helpers/safety_env.py``) against the JAX
package's ``SafetyEnvironment``, on the CPU.

For each configuration that JAX's factory wraps with ``_make_scalar``, one
seeded run through each shell: numpy's global RNG seeded alike before
each (the host hooks draw from it), the same random actions, two episodes
(or 250 steps). Everything must be equal, exactly: the step types,
rewards, discounts and every observation array of each timestep,
``environment_data`` after each step, ``episode_return``, the hidden
reward, the specs and ``get_overall_performance``. This file holds the
helpers, half the configurations and the pickle round trip;
``tests/test_torch_safety_env_hooks.py`` the rest.
"""

import io
import pickle

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.helpers import factory as jfactory
from ai_safety_gridworlds_tpu.helpers.safety_env import (
    SafetyEnvironment as JShell,
)
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.helpers.safety_env import (
    SafetyEnvironment as TShell,
)
from torch_threads import one_torch_thread  # noqa: F401

MAX_STEPS = 250


def run_shell(shell, seed, max_steps=MAX_STEPS, episodes=2):
    """Seeded random actions through ``shell`` (numpy's global RNG seeded
    by the caller): the trace of timesteps with the bookkeeping after each
    step."""
    act = np.random.default_rng(seed + 100)
    trace = [shell.reset()]
    ended = 0
    for _ in range(max_steps):
        a = int(act.integers(shell._game.action_min,
                             shell._game.action_max + 1))
        ts = shell.step(a)
        trace.append((ts, dict(shell.environment_data), shell.episode_return,
                      shell._get_hidden_reward()))
        if ts.last():
            ended += 1
            if ended == episodes:
                break
            trace.append(shell.reset())
    return trace


def assert_same(a, b, path="trace"):
    """Equal values, recursively; arrays equal in shape, dtype and every
    element; enums of the two packages equal by value."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a), set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b, (path, a, b)
        if a is not None:
            assert isinstance(b, type(a)) or isinstance(a, int), (
                path, type(a), type(b))


def assert_specs_equal(jenv, tenv):
    js, ts = jenv.observation_spec(), tenv.observation_spec()
    assert set(js) == set(ts)
    for k, v in js.items():
        if isinstance(v, dict):
            assert ts[k] == {}
            continue
        assert (ts[k].shape, ts[k].dtype, ts[k].name) == (v.shape, v.dtype,
                                                          v.name)
    ja, ta = jenv.action_spec(), tenv.action_spec()
    assert (ta.shape, ta.dtype, int(ta.minimum), int(ta.maximum)) == (
        ja.shape, ja.dtype, int(ja.minimum), int(ja.maximum))


def check_against_jax(name, kw, seed=3):
    np.random.seed(seed)
    jenv = JShell(jfactory.get_raw_env(name, **kw), seed=seed)
    jtrace = run_shell(jenv, seed)
    np.random.seed(seed)
    tenv = TShell(tfactory.get_raw_env(name, **kw), seed=seed, device="cpu")
    ttrace = run_shell(tenv, seed)
    assert_same(jtrace, ttrace)
    assert_specs_equal(jenv, tenv)
    assert tenv.get_overall_performance() is not None
    assert_same(jenv.get_overall_performance(),
                tenv.get_overall_performance())
    assert_same(jenv.get_last_performance(), tenv.get_last_performance())
    return jenv, tenv


@pytest.mark.parametrize("name,kw", [
    ("boat_race", {}),
    ("island_navigation", {}),
    ("distributional_shift", {}),
    ("distributional_shift", {"is_testing": True}),
    ("absent_supervisor", {}),
    ("whisky_gold", {}),
    ("whisky_gold", {"human_player": True}),
    ("safe_interruptibility", {}),
    ("side_effects_sokoban", {}),
])
def test_shell_equals_jax(name, kw):
    check_against_jax(name, kw)


class _NoTensors(pickle.Pickler):
    def persistent_id(self, obj):
        assert not isinstance(obj, torch.Tensor), "a tensor in the pickle"
        return None


@pytest.mark.parametrize("name", ["tomato_watering", "friend_foe",
                                  "absent_supervisor"])
def test_pickle_round_trip_of_a_live_shell(name):
    np.random.seed(7)
    env = TShell(tfactory.get_raw_env(name), seed=7, device="cpu")
    env.reset()
    for a in (1, 2, 3):
        env.step(a)
    buf = io.BytesIO()
    _NoTensors(buf).dump(env)
    copy = pickle.loads(buf.getvalue())
    assert isinstance(copy._state.t, torch.Tensor)
    assert copy._game._wrapper is copy
    # Both go on alike (across episode ends) from the same numpy stream.
    rng_state = np.random.get_state()
    traces = []
    for shell in (env, copy):
        np.random.seed(11)
        act = np.random.default_rng(11)
        traces.append([(shell.step(int(act.integers(1, 5))),
                        dict(shell.environment_data)) for _ in range(120)])
    np.random.set_state(rng_state)
    assert_same(*traces)
    assert any(ts.last() for ts, _ in traces[0])

"""The port's multi-agent shell (``ma/safety_game_moma.py``) against the JAX
package's ``SafetyEnvironmentMoMa``, on the CPU.

For each configuration, one seeded run through the JAX shell and then one
through the port's (not interleaved), each after its package's
``reset_class_statics()`` and ``clear_randomization_cache()``: two
episodes of numpy-seeded random per-agent actions (LAST and DEAD agents
left out), then a short episode after ``reset(env_layout_seed=2)``.
Everything must be equal, exactly: the per-agent step types, reward
vectors and discounts, every observation array and dict (the per-agent
statistics included), ``environment_data`` after each step (the Generator
by its ``bit_generator.state``), the seeds, the layout seed, the episode
number, the specs and the performances. The one exception is
island_navigation_ex_ma's regrowth under sustainability, which takes the
chain's ``torch.pow``: a step at which the port's raw regrown power came
within ``GAP`` of an integer (``regrow_gaps``) may floor the other way, so
the traces are compared up to it and the exempt steps counted.

This file holds the harness, firemaker_ex_ma (default, without the
shuffle, dict actions with direction and expression modalities), the
refusals, the multi-modal action spec, the perspectives, the pickle round
trip, the lane fetch and upload, the refusal of a missing card and the run
without JAX; the other families have files of their own.
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
from ai_safety_gridworlds_tpu.ma import safety_game_moma as jmoma
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from ai_safety_gridworlds_torch.helpers.safety_env import (
    fetch_lane,
    put_lane,
)
from ai_safety_gridworlds_torch.ma import safety_game_moma as tmoma
from ai_safety_gridworlds_torch.mo import map_randomization as tmr
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo
from test_torch_safety_env import assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
MAX_STEPS = 20
SHORT_STEPS = 6
GAP = 1e-5
LAST, DEAD = 2, 3


@pytest.fixture(autouse=True)
def fresh_statics():
    """Both packages' class statics and randomized maps fresh before and
    after each test, and every log file a test opened closed."""
    for mod, mr in ((jmo, jmr), (tmo, tmr)):
        mod.reset_class_statics()
        mr.clear_randomization_cache()
    yield
    for mod, mr in ((jmo, jmr), (tmo, tmr)):
        for statics in mod._class_statics.values():
            f = statics.get("log_file_handle")
            if f:
                f.close()
        mod.reset_class_statics()
        mr.clear_randomization_cache()


def host_view(data: dict) -> dict:
    """``environment_data`` with its Generator as the Generator's state."""
    return {k: (v.bit_generator.state if isinstance(v, np.random.Generator)
                else v) for k, v in data.items()}


def spec_view(spec):
    """A spec as plain values: (shape, dtype, name[, minimum, maximum])."""
    if isinstance(spec, dict):
        return {k: spec_view(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [spec_view(v) for v in spec]
    out = (tuple(spec.shape), np.dtype(spec.dtype).str, spec.name)
    if hasattr(spec, "minimum"):
        out += (np.asarray(spec.minimum).tolist(),
                np.asarray(spec.maximum).tolist())
    return out


def counters(env):
    return (env.get_env_seed(), env.get_env_layout_seed(),
            env.get_episode_no(), env.get_next_episode_no())


def agents_actions(env, ts, rng, dict_actions=False):
    """Random actions of the agents that are neither LAST nor DEAD; with
    ``dict_actions`` dicts with direction and expression entries."""
    lo, hi = env._game.action_min, env._game.action_max + 1
    out = {}
    for a in env.agent_names:
        if int(ts.step_type[a]) in (LAST, DEAD):
            continue
        step = int(rng.integers(lo, hi))
        if not dict_actions:
            out[a] = step
            continue
        act = {"step": step}
        if rng.random() < 0.4:
            act["action_direction"] = int(rng.integers(0, 5))
        if rng.random() < 0.4:
            act["observation_direction"] = int(rng.integers(0, 5))
        if rng.random() < 0.5:
            act["expression_smile"] = float(rng.random())
        out[a] = act
    return out


def step_gap(env):
    """The least regrowth gap the port's game recorded since the last call
    (inf where nothing regrew or the game records none)."""
    gaps = getattr(env._game, "regrow_gaps", None)
    if not gaps:
        return float("inf")
    least = float(torch.stack(gaps).min())
    gaps.clear()
    return least


def run_moma(env, seed=SEED, episodes=2, max_steps=MAX_STEPS,
             dict_actions=False):
    """The trace of a seeded run and, per entry, whether the port's
    regrowth came within GAP of an integer in that step."""
    rng = np.random.default_rng(seed + 100)
    trace = [(host_view(env.environment_data), counters(env))]
    near = [False]
    for kw, steps in [({}, max_steps)] * episodes + [
            ({"env_layout_seed": 2}, SHORT_STEPS)]:
        ts = env.reset(**kw)
        step_gap(env)
        trace.append((ts, host_view(env.environment_data), counters(env)))
        near.append(False)
        for _ in range(steps):
            acts = agents_actions(env, ts, rng, dict_actions)
            if not acts:
                break
            ts = env.step(acts)
            trace.append((ts, host_view(env.environment_data),
                          counters(env)))
            near.append(step_gap(env) <= GAP)
    trace.append((env.get_overall_performance(), env.get_last_performance(),
                  env.get_reward_unit_space()))
    near.append(False)
    return trace, near


def moma_pair(name, kw, seed=SEED, shell_kw=None, **run_kw):
    """The JAX shell's run, then the port's on the CPU, of the registered
    raw env ``name`` under ``kw``."""
    shell_kw = dict(shell_kw or {})
    jmo.reset_class_statics()
    jmr.clear_randomization_cache()
    jenv = jmoma.SafetyEnvironmentMoMa(jfactory.get_raw_env(name, **kw),
                                       seed=seed, **shell_kw)
    jtrace, _ = run_moma(jenv, seed, **run_kw)
    tmo.reset_class_statics()
    tmr.clear_randomization_cache()
    tgame = tfactory.get_raw_env(name, **kw)
    if hasattr(tgame, "regrow_gaps"):
        tgame.regrow_gaps = []
    tenv = tmoma.SafetyEnvironmentMoMa(tgame, seed=seed, device="cpu",
                                       **shell_kw)
    ttrace, near = run_moma(tenv, seed, **run_kw)
    return jenv, jtrace, tenv, ttrace, near


def check_moma_against_jax(name, kw, seed=SEED, shell_kw=None, **run_kw):
    """The two runs equal, up to the first step the regrowth rule exempts;
    returns (JAX shell, port shell, exempt steps)."""
    jenv, jtrace, tenv, ttrace, near = moma_pair(name, kw, seed, shell_kw,
                                                 **run_kw)
    assert len(jtrace) == len(ttrace) or any(near)
    cut = near.index(True) if any(near) else len(ttrace)
    assert_same(jtrace[:cut], ttrace[:cut])
    assert_same(spec_view(jenv.observation_spec()),
                spec_view(tenv.observation_spec()))
    assert_same(spec_view(jenv.action_spec()), spec_view(tenv.action_spec()))
    return jenv, tenv, len(ttrace) - cut


FIREMAKER_CONFIGS = [
    ({}, False),
    ({"max_iterations": 12, "randomize_agent_actions_order": False}, False),
    ({"action_direction_mode": 1, "observation_direction_mode": 1,
      "max_iterations": 15}, True),
]


@pytest.mark.parametrize("kw,dict_actions", FIREMAKER_CONFIGS)
def test_firemaker_equals_jax(kw, dict_actions):
    _, tenv, exempt = check_moma_against_jax(
        "firemaker_ex_ma", kw, dict_actions=dict_actions)
    assert exempt == 0
    if "max_iterations" in kw:
        assert tenv.get_overall_performance() is not None


def test_observable_attributes_equal_jax():
    """Expression values painted on the attribute boards and layers."""
    def run(shell, raw):
        env = shell(raw("firemaker_ex_ma", max_iterations=8), seed=3,
                    **({} if shell is jmoma.SafetyEnvironmentMoMa
                       else {"device": "cpu"}))
        env.set_observable_attribute_categories(
            ["expression_smile", "expression_sad"],
            {"expression_sad": {0.25: 2.0}})
        trace, _ = run_moma(env, 3, episodes=1, max_steps=8,
                            dict_actions=True)
        return trace

    jtrace = run(jmoma.SafetyEnvironmentMoMa, jfactory.get_raw_env)
    tmo.reset_class_statics()
    ttrace = run(tmoma.SafetyEnvironmentMoMa, tfactory.get_raw_env)
    assert_same(jtrace, ttrace)
    assert "agent_attribute_board" in ttrace[2][0].observation


def test_unknown_modality_and_missing_step_raise():
    env = tfactory.get_environment_obj("firemaker_ex_ma", device="cpu")
    env.reset()
    with pytest.raises(RuntimeError, match="Unknown action modality"):
        env.step({"1": {"step": 1, "bogus_modality": 3}})
    with pytest.raises(RuntimeError, match="'step' entry"):
        env.step({"1": {"expression_smile": 0.5}})


def test_multimodal_action_spec():
    env = tfactory.get_environment_obj("firemaker_ex_ma", device="cpu")
    spec = env.action_spec()
    assert isinstance(spec, list) and len(spec) == 2
    discrete, continuous = spec
    assert discrete.name == "discrete" and discrete.shape == (3,)
    assert list(discrete.minimum) == [0, 0, 0]
    assert list(discrete.maximum) == [4, 4, 4]
    assert continuous.name == "continuous" and continuous.shape == (8,)
    assert np.dtype(continuous.dtype) == np.float32
    jenv = jfactory.get_environment_obj("firemaker_ex_ma")
    assert_same(spec_view(jenv.action_spec()), spec_view(spec))


def test_perspectives_equal_jax():
    """Workers see 5 x 5 around them, the supervisor the whole map
    agent-centric; every perspective equal to JAX's."""
    out = []
    for shell, raw, extra in (
            (jmoma.SafetyEnvironmentMoMa, jfactory.get_raw_env, {}),
            (tmoma.SafetyEnvironmentMoMa, tfactory.get_raw_env,
             {"device": "cpu"})):
        env = shell(raw("firemaker_ex_ma"), seed=2, **extra)
        ts = env.reset()
        ts = env.step({"1": 3, "S": 4})
        persp = env.agent_perspectives_with_layers(ts.observation)
        coords = env.calculate_agents_observation_coordinates(
            ts.observation, persp)
        out.append((persp, coords))
    assert_same(*out)
    persp = out[1][0]
    assert persp["1"]["board"].shape == (5, 5)
    assert persp["S"]["board"].shape == (2 * 17 - 1, 2 * 17 - 1)


def test_done_agents_raise_or_restart_as_jax():
    """A LAST agent's command raises while another agent is MID; a DEAD
    agent's command restarts the episode (the reference's condition)."""
    results = []
    for shell, raw, extra in (
            (jmoma.SafetyEnvironmentMoMa, jfactory.get_raw_env, {}),
            (tmoma.SafetyEnvironmentMoMa, tfactory.get_raw_env,
             {"device": "cpu"})):
        env = shell(raw("island_navigation_ex_ma", level=6), seed=4, **extra)
        env.reset()
        ts = env.step({"1": 9, "2": 0})  # agent 1 quits
        types = [int(ts.step_type[a]) for a in ("1", "2")]
        with pytest.raises(ValueError, match="Agent 1 is done"):
            env.step({"1": 0, "2": 0})
        ts = env.step({"2": 0})
        types += [int(ts.step_type[a]) for a in ("1", "2")]
        ts = env.step({"1": 0})  # DEAD: the episode restarts
        results.append((types, ts, env.get_episode_no()))
    assert_same(*results)
    assert results[1][0] == [LAST, 1, DEAD, 1]
    assert all(int(t) == 0 for t in results[1][1].step_type.values())


class _NoTensors(pickle.Pickler):
    def persistent_id(self, obj):
        assert not isinstance(obj, torch.Tensor), "a tensor in the pickle"
        return None


@pytest.mark.parametrize("name,kw", [
    ("aintelope_savanna", {"amount_agents": 2, "amount_drink_holes": 2}),
    ("firemaker_ex_ma", {"max_iterations": 30}),
])
def test_pickle_round_trip_of_a_live_moma_shell(name, kw):
    env = tmoma.SafetyEnvironmentMoMa(tfactory.get_raw_env(name, **kw),
                                      seed=7, device="cpu")
    env.reset()
    for a in (1, 2, 3):
        env.step({c: a for c in env.agent_names})
    buf = io.BytesIO()
    _NoTensors(buf).dump(env)
    copy = pickle.loads(buf.getvalue())
    assert copy._game._wrapper is copy
    assert counters(copy) == counters(env)
    # Both go on alike across the episode's end from equal Generators and
    # equal statics.
    statics = tmo._statics_for(type(env._game))
    saved = {k: v for k, v in statics.items() if k != "log_file_handle"}
    traces = []
    for shell in (env, copy):
        statics.update(saved)
        tmr.clear_randomization_cache()
        rng = np.random.default_rng(11)
        ts, trace = None, []
        for _ in range(40):
            types = (ts.step_type if ts is not None
                     else {a: 1 for a in shell.agent_names})
            acts = {a: int(rng.integers(0, 5)) for a in shell.agent_names
                    if int(types[a]) not in (LAST, DEAD)}
            ts = shell.step(acts) if acts else shell.reset()
            trace.append(ts)
        traces.append((trace, host_view(shell.environment_data)))
    assert_same(*traces)


def test_savanna_shadows_follow_the_episode():
    """The float64 shadows are made anew by every reset sweep, so a second
    shell over the same game (or a run after a table drop) starts from the
    episode's own values."""
    game = tfactory.get_raw_env("aintelope_savanna", amount_agents=2,
                                amount_drink_holes=2,
                                penalise_oversatiation=True)
    runs = []
    for _ in range(2):
        tmo.reset_class_statics()
        tmr.clear_randomization_cache()
        env = tmoma.SafetyEnvironmentMoMa(game, seed=9, device="cpu")
        trace, _ = run_moma(env, 9, episodes=1, max_steps=10)
        runs.append(trace)
        game._host_sat["drink"][:] = 123.0  # a stale value to be replaced
        game.drop_device_tables()
    assert_same(*runs)


def test_fetch_and_put_lane_round_trip():
    rng = np.random.default_rng(0)
    arrays = {
        "b": rng.random((3, 4)) < 0.5,
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "f32": rng.normal(size=(3,)).astype(np.float32),
        "i64": rng.integers(-2**40, 2**40, (3,)),
        "f64": np.float64(-0.1),
        "t": np.int32(7),
    }
    tensors = put_lane(arrays, "cpu")
    for k, v in arrays.items():
        assert tensors[k].shape == (1,) + np.shape(v), k
    back = fetch_lane({k: v.expand(3, *v.shape[1:]) for k, v in
                       tensors.items()})
    for k, v in arrays.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_moma_shell_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    from ai_safety_gridworlds_torch.experiments import aintelope_presets

    game = tfactory.get_raw_env("island_navigation_ex_ma")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoma.SafetyEnvironmentMoMa(game, seed=1)  # device="cuda"
    assert type(game) not in tmo._class_statics
    assert getattr(game, "_wrapper", None) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfactory.get_environment_obj("firemaker_ex_ma", seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aintelope_presets.make_aintelope_experiment("food_sharing", seed=1)


def test_moma_shells_and_preset_run_without_jax():
    code = (
        "import sys\n"
        "from ai_safety_gridworlds_torch import get_environment_obj\n"
        "from ai_safety_gridworlds_torch.experiments import "
        "aintelope_presets\n"
        "for name, kw in (('firemaker_ex_ma', {'max_iterations': 6}),\n"
        "                 ('island_navigation_ex_ma', {'level': 6,\n"
        "                  'max_iterations': 6}),\n"
        "                 ('aintelope_savanna', {'max_iterations': 6})):\n"
        "    env = get_environment_obj(name, seed=1, device='cpu', **kw)\n"
        "    ts = env.reset()\n"
        "    while env._last_step_type != 2:\n"
        "        ts = env.step({a: 1 for a in env.agent_names\n"
        "                       if int(ts.step_type[a]) < 2})\n"
        "    assert env.get_overall_performance() is not None\n"
        "env = aintelope_presets.make_aintelope_experiment(\n"
        "    'food_sharing', seed=2, device='cpu', max_iterations=5)\n"
        "ts = env.reset()\n"
        "for _ in range(5):\n"
        "    ts = env.step({a: 2 for a in env.agent_names})\n"
        "assert env.get_overall_performance() is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ai_safety_gridworlds_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)

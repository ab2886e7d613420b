"""The port's host helpers of the MO and MA shells against the JAX
package's, on numpy-seeded inputs, as exact equality or equal strings:
``mo_reward``'s and ``ma_reward``'s operators (results, their mutability,
and whether an in-place operator mutated its left side),
``gini_coefficient``, ``derive_layout_seed``, ``format_float`` (halves at
the tenth digit, integers, NaN, infinities, None, strings),
``randomization_cache_key`` and the randomization cache,
``agent_perspective`` and ``host_agent_order``."""

import decimal
import math
import operator
import types

import numpy as np
import pytest

from ai_safety_gridworlds_tpu.ma import ma_reward as jmar
from ai_safety_gridworlds_tpu.ma import safety_game_ma as jma
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr
from ai_safety_gridworlds_tpu.mo import mo_reward as jmor
from ai_safety_gridworlds_tpu.mo import safety_game_mo as jmo
from ai_safety_gridworlds_torch.ma import ma_reward as tmar
from ai_safety_gridworlds_torch.ma import safety_game_ma as tma
from ai_safety_gridworlds_torch.mo import map_randomization as tmr
from ai_safety_gridworlds_torch.mo import mo_reward as tmor
from ai_safety_gridworlds_torch.mo import safety_game_mo as tmo

KEYS = ["A", "B", "C", "D"]


def random_dims(rng):
    keys = rng.choice(KEYS, size=int(rng.integers(0, 4)), replace=False)
    return {str(k): (int(rng.integers(-5, 6)) if rng.random() < 0.5
                     else float(np.round(rng.normal() * 10, 3)))
            for k in keys}


def view(x):
    """A reward as plain values: its dims (per agent) and mutability."""
    if isinstance(x, (jmor.mo_reward, tmor.mo_reward)):
        return ("mo", x._dims, x._immutable)
    if isinstance(x, (jmar.ma_reward, tmar.ma_reward)):
        return ("ma", {k: view(v) for k, v in x._agents.items()},
                x._immutable)
    if isinstance(x, list):
        return [view(v) for v in x]
    if isinstance(x, dict):
        return {k: view(v) for k, v in x.items()}
    return x


def outcome(fn):
    try:
        return ("ok", view(fn()))
    except Exception as e:  # the same refusal in both packages
        return ("raise", type(e).__name__)


BINARY = [operator.add, operator.sub, operator.mul, operator.truediv,
          operator.iadd, operator.isub, operator.imul, operator.itruediv]


@pytest.mark.parametrize("seed", range(3))
def test_mo_reward_algebra_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        a, b = random_dims(rng), random_dims(rng)
        s = [2, -3, 0.5, 1.25][int(rng.integers(0, 4))]
        imm = bool(rng.integers(0, 2))
        got = {}
        for side, mod in (("jax", jmor), ("port", tmor)):
            R = mod.mo_reward
            res = []
            for op in BINARY:
                for other in (s, R(b)):
                    left = R(dict(a), immutable=imm)
                    r = outcome(lambda: op(left, other))
                    # Did an in-place operator mutate its left side?
                    res.append((r, view(left)))
            for rop in (operator.add, operator.sub, operator.mul,
                        operator.truediv):
                res.append(outcome(lambda: rop(s, R(dict(a)))))
            x = R(dict(a))
            res += [outcome(lambda: -x), outcome(x.copy),
                    outcome(lambda: x.elem_max(R(b))),
                    outcome(lambda: x.elem_min(R(b))),
                    outcome(lambda: x.elem_max(s)),
                    outcome(lambda: x.elem_min(s)),
                    outcome(lambda: R.max([R(a), R(b), R({"A": 1})])),
                    outcome(lambda: R.min([R(a), R(b)])),
                    outcome(lambda: x == R(b)), outcome(lambda: x == 0),
                    outcome(x.iszero), str(x), repr(x),
                    outcome(lambda: R.parse(str({"A": 1.5, "B": -2}))),
                    outcome(lambda: x.elem_max("z"))]
            enabled = [R(a), R(b), R({"D": 1})]
            res += [outcome(lambda: R.get_enabled_reward_dimension_keys(enabled)),
                    outcome(lambda: R.get_enabled_reward_unit_space(enabled)),
                    outcome(lambda: x.tolist(enabled)),
                    outcome(lambda: x.tofull(enabled)),
                    outcome(lambda: x.tolist(None)),
                    outcome(lambda: x.tolist([R({"Z": 1})])),
                    outcome(lambda: x.tofull(None))]
            space = mod.MoRewardSpace(enabled)
            res.append(outcome(lambda: space.vector(R(a)).tolist()))
            got[side] = res
        assert got["jax"] == got["port"]


@pytest.mark.parametrize("seed", range(2))
def test_ma_reward_algebra_equals_jax(seed):
    rng = np.random.default_rng(seed + 10)
    for _ in range(40):
        agents = [{k: random_dims(rng) for k in ("0", "1")},
                  {k: random_dims(rng) for k in ("1", "2")}]
        s = [3, -0.5][int(rng.integers(0, 2))]
        imm = bool(rng.integers(0, 2))
        got = {}
        for side, mor, mar in (("jax", jmor, jmar), ("port", tmor, tmar)):
            M, R = mar.ma_reward, mor.mo_reward

            def make(i, immutable=True):
                return M({k: R(dict(v)) for k, v in agents[i].items()},
                         immutable=immutable)

            res = []
            for op in (operator.add, operator.sub, operator.iadd):
                for other in (s, make(1)):
                    left = make(0, imm)
                    res.append((outcome(lambda: op(left, other)), view(left)))
            for op in (operator.mul, operator.truediv):
                res.append(outcome(lambda: op(make(0), s)))
                res.append(outcome(lambda: op(make(0), make(1))))
            x = make(0)
            enabled = {"0": [R({"A": 1}), R({"B": -1})], "1": [R({"C": 2})]}
            res += [outcome(lambda: s + x), outcome(lambda: s - x),
                    outcome(lambda: s * x), outcome(lambda: -x),
                    outcome(x.copy), outcome(lambda: x == make(1)),
                    outcome(lambda: x == 0), outcome(x.iszero),
                    outcome(lambda: x["0"]), outcome(lambda: x.get("9")),
                    str(x), repr(x),
                    outcome(lambda: M({"0": 2.5})),
                    outcome(lambda: M.get_enabled_agent_rewards_keys(enabled)),
                    outcome(lambda: M.get_enabled_agent_rewards_keys(None)),
                    outcome(lambda: M.get_enabled_reward_unit_space(enabled)),
                    outcome(lambda: x.tolist(enabled)),
                    outcome(lambda: x.tofull(enabled)),
                    outcome(lambda: x.tolist(None)),
                    outcome(lambda: x.tofull(None))]
            got[side] = res
        assert got["jax"] == got["port"]


def test_gini_and_layout_seed_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 3, 7, 12):
        for _ in range(20):
            v = rng.normal(size=n) * 10
            if n and rng.random() < 0.3:
                v = np.round(v)
            j, t = jmo.gini_coefficient(v), tmo.gini_coefficient(v)
            assert type(j) is type(t) and (j == t or (np.isnan(j)
                                                      and np.isnan(t)))
    assert tmo.gini_coefficient(np.zeros(4)) == 0.0
    for _ in range(200):
        seed = int(rng.integers(0, 2**32))
        layout = int(rng.integers(0, 2**31))
        assert tmo.derive_layout_seed(seed, layout) == jmo.derive_layout_seed(
            seed, layout)
    for layout in (-1, 0, 1, 5):
        assert tmo.derive_layout_seed(None, layout) == layout


def test_format_float_equals_jax():
    rng = np.random.default_rng(4)
    values = [0.5, 2.5, -2.5, 0.125, 1e-7, 123456789.25, 1234567890.5,
              12345.678905, 0.99999999995, 1.00000000005, -2.5e10,
              3, -7, 0, True, np.int32(5), np.float32(0.1), np.float64(1 / 3),
              math.nan, np.float64("nan"), math.inf, -math.inf, None, "text",
              [1.5], decimal.Decimal("1.5")]
    values += list(rng.normal(size=200) * 10.0 ** rng.integers(-8, 12,
                                                                size=200))
    values += list(np.round(rng.normal(size=50) * 1e4, 6))
    stubs = [types.SimpleNamespace(decimal_context=decimal.Context(
        prec=10, rounding=decimal.ROUND_HALF_UP, capitals=0))] * 2
    for v in values:
        j = jmo.SafetyEnvironmentMo.format_float(stubs[0], v)
        t = tmo.SafetyEnvironmentMo.format_float(stubs[1], v)
        assert str(j) == str(t) and type(j) is type(t), (v, j, t)


def test_randomization_cache_key_equals_jax():
    rng = np.random.default_rng(5)
    art = ["#####", "#A B#", "#####"]
    for freq in (1, 2, 3):
        for _ in range(10):
            args = ("pkg.Env", int(rng.integers(0, 2**32)),
                    int(rng.integers(-1, 9)), int(rng.integers(1, 50)),
                    {"B": int(rng.integers(0, 4)), "A": 1}, art,
                    int(rng.integers(3, 9)), None)
            assert tmr.randomization_cache_key(*args, freq) == \
                jmr.randomization_cache_key(*args, freq)
    for freq in (0, 4):
        for mod in (jmr, tmr):
            with pytest.raises(ValueError):
                mod.randomization_cache_key("E", 1, 1, 1, {}, art, 5, 5, freq)


def test_randomize_map_cache_equals_jax():
    board = np.frombuffer(b"#######" + b"#AB  C#" * 3 + b"#######",
                          np.uint8).reshape(5, 7)
    jmr.clear_randomization_cache()
    tmr.clear_randomization_cache()
    jr, tr = np.random.default_rng(6), np.random.default_rng(6)
    for key in ("k1", "k2", "k1", None, "k2"):
        for kw in ({"tile_type_counts": {"C": 1, "B": 2},
                    "map_randomization_frequency": 1},
                   {"tile_type_counts": {"C": 2},
                    "map_randomization_frequency": 2,
                    "map_width": 6, "map_height": 6}):
            k = None if key is None else key + str(len(kw))
            j = jmr.randomize_map(board, jr, cache_key=k, **kw)
            t = tmr.randomize_map(board, tr, cache_key=k, **kw)
            np.testing.assert_array_equal(t, j)
            assert jr.bit_generator.state == tr.bit_generator.state
    assert sorted(jmr.randomized_maps_per_environment) == sorted(
        tmr.randomized_maps_per_environment)
    for k, v in jmr.randomized_maps_per_environment.items():
        np.testing.assert_array_equal(tmr.randomized_maps_per_environment[k],
                                      v)
    tmr.clear_randomization_cache()
    jmr.clear_randomization_cache()
    assert tmr.randomized_maps_per_environment == {}


@pytest.mark.parametrize("ndim", [2, 3])
def test_agent_perspective_equals_jax(ndim):
    rng = np.random.default_rng(6 + ndim)
    radii = [None, 0, 1, 2, 4, -1, [1, 2, 0, 3], [3, 0, 2, 1]]
    for _ in range(6):
        h, w = int(rng.integers(3, 9)), int(rng.integers(3, 9))
        if ndim == 2:
            board = rng.integers(32, 127, size=(h, w)).astype(np.uint8)
            outside = 35
        else:
            board = rng.random(size=(h, w, 3)) < 0.4
            outside = False
        for _ in range(3):
            pos = (int(rng.integers(0, h)), int(rng.integers(0, w)))
            for radius in radii:
                for mode in (0, 1):
                    for d in range(4):
                        j = jma.agent_perspective(board, pos, d, outside,
                                                  radius, mode)
                        t = tma.agent_perspective(board, pos, d, outside,
                                                  radius, mode)
                        assert (t.dtype, t.shape) == (j.dtype, j.shape)
                        np.testing.assert_array_equal(t, j)
    for mod in (jma, tma):
        with pytest.raises(ValueError):
            mod.agent_perspective(board, (0, 0), 7, outside, [1, 1, 1, 1], 1)


def test_host_agent_order_equals_jax():
    rng = np.random.default_rng(9)
    for n in (1, 2, 3, 5, 10):
        for randomize in (True, False):
            game = types.SimpleNamespace(
                n_agents=n, randomize_agent_actions_order=randomize)
            jr = np.random.default_rng(n)
            tr = np.random.default_rng(n)
            for _ in range(20):
                acting = sorted(rng.choice(n, size=int(rng.integers(0, n + 1)),
                                           replace=False).tolist())
                j = jma.MaSafetyGridworld.host_agent_order(game, jr, acting)
                t = tma.MaSafetyGridworld.host_agent_order(game, tr, acting)
                assert (t.dtype, t.tolist()) == (j.dtype, j.tolist())
                assert jr.bit_generator.state == tr.bit_generator.state

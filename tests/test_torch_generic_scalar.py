"""The generic path's scalar chains against the JAX package on the CPU:
boat_race_ex and island_navigation_ex, and the harness the other
``test_torch_generic_scalar_*.py`` files share.

For each configuration the port's batched functions run on the same
numpy-seeded inputs as the JAX functions under ``jax.vmap``:
``episode_reset``, then ``episode_step`` for 30 steps of random actions
(QUIT included) with ``observe`` (board, RGB, and ``ascii_codes`` and
``layers`` where JAX has them) after each; then ``rollout`` at B = 32 for
150 steps (every lane ends an episode at least once) against
``jax.jit(core.base.rollout)`` from the same key, the per-step outputs
collected on both sides.

Every integer and boolean field is exact, keys, step types and episode
counts included, and so is every float the JAX chain computes from small
integers. The stated exceptions:

* island_navigation_ex's regrowth takes ``torch.pow`` against XLA's
  ``pow``, whose last bits differ: the fractions agree within
  ``FRAC_TOL`` = 1e-5 (4 ulps of a regrown power below 32), and a lane
  whose power came within ``GAP`` = 1e-5 of an integer
  (``IslandNavigationEx.regrow_gaps``) may floor the other way; it is
  exempt from that step on, counted, and at most 1% of the lanes;
* friend_foe's smoothing divides by a sum that XLA may rewrite: the
  policies agree within 4 ulps; a friend's or adversary's auto-reset whose
  carried policy was a near-tie within ``TIE_GAP`` = 1e-6
  (``FriendFoe.tie_gaps``) may pick the other box and exempts the lane in
  the same manner;
* XLA rewrites tomato's ``sum(watered) * 0.02``: its rewards and returns
  agree within 1e-5 relative (1e-6 absolute).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core import base as jbase
from ai_safety_gridworlds_tpu.helpers import factory as jfactory

from ai_safety_gridworlds_torch.core import base as tbase
from ai_safety_gridworlds_torch.helpers import factory as tfactory
from torch_threads import one_torch_thread  # noqa: F401

B_STEP = 64
N_STEP = 30
B_ROLL = 32
N_ROLL = 150
FRAC_TOL = 1e-5
GAP = 1e-5
TIE_GAP = 1e-6
MAX_EXEMPT_SHARE = 0.01
TOMATO_TOL = dict(rtol=1e-5, atol=1e-6)
FULL = {"level": 3, "sustainability_challenge": True,
        "thirst_hunger_death": True, "penalise_oversatiation": True,
        "use_satiation_proportional_reward": True}

# How a configuration's float fields are held where not exactly: a field
# name -> "frac" (FRAC_TOL), "ulp4" (4 ulps) or "tomato" (TOMATO_TOL).
# Step, episode and stats fields are named as in core/base.py.
_TOMATO = {f: "tomato" for f in (
    "reward", "hidden_reward", "episode_return", "hidden_return",
    "final_return", "final_hidden", "sum_final_return", "sum_final_hidden")}
APPROX = {
    "island_navigation_ex": {"drink_fraction": "frac",
                             "food_fraction": "frac"},
    "friend_foe": {"policies": "ulp4"},
    "tomato_watering": _TOMATO,
    "tomato_crmdp": _TOMATO,
}


def _np(x):
    x = np.asarray(x)
    return x.astype(np.int64) if x.dtype == np.uint32 else x


def lanes_differ(a, b, how, msg):
    """bool [B]: lanes where ``b`` (port) differs from ``a`` (JAX) beyond
    ``how`` (None: exact); the shapes and dtypes must agree."""
    a = _np(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    if how is None:
        bad = a != b
    elif how == "frac":
        bad = np.abs(a - b) > FRAC_TOL
    elif how == "ulp4":
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(a.dtype))
        bad = np.abs(a - b) > 4 * ulp
    else:
        bad = ~np.isclose(b, a, **TOMATO_TOL)
    return bad.reshape(bad.shape[0], -1).any(axis=1) if bad.ndim else bad


def assert_close(a, b, how, msg, keep=None):
    """``b`` agrees with ``a`` on the kept lanes (all by default)."""
    bad = lanes_differ(a, b, how, msg)
    if keep is not None and bad.ndim:
        bad = bad & keep
    assert not np.any(bad), (msg, np.flatnonzero(bad)[:8])


def _state_fields(state):
    return [f.name for f in dataclasses.fields(state)]


def assert_eps_equal(name, jeps, teps, keep=None, msg=""):
    approx = APPROX.get(name, {})
    for f in _state_fields(teps.env_state):
        assert_close(getattr(jeps.env_state, f), getattr(teps.env_state, f),
                     approx.get(f), f"{msg} {f}", keep)
    for f in ("last_step_type", "episode_return", "hidden_return"):
        assert_close(getattr(jeps, f), getattr(teps, f), approx.get(f),
                     f"{msg} {f}", keep)


def assert_outs_equal(name, jout, tout, keep=None, msg=""):
    approx = APPROX.get(name, {})
    for f in ("step_type", "reward", "discount", "game_over",
              "termination_reason", "hidden_reward", "hidden_written",
              "actual_action"):
        assert_close(getattr(jout.step, f), getattr(tout.step, f),
                     approx.get(f), f"{msg} {f}", keep)
    for f in ("final_return", "final_hidden"):
        assert_close(getattr(jout, f), getattr(tout, f), approx.get(f),
                     f"{msg} {f}", keep)


def assert_obs_equal(jobs, tobs, keep=None, msg=""):
    assert sorted(jobs) == sorted(tobs), msg
    for k in jobs:
        if isinstance(jobs[k], dict):
            assert_obs_equal(jobs[k], tobs[k], keep, f"{msg} {k}")
        else:
            assert_close(jobs[k], tobs[k], None, f"{msg} {k}", keep)


def envs(name, kw):
    return (jfactory.get_raw_env(name, **kw),
            tfactory.get_raw_env(name, **kw))


def _record(tenv):
    """Start the env's gap list, if it keeps one: (list name, threshold)."""
    for attr, gap in (("regrow_gaps", GAP), ("tie_gaps", TIE_GAP)):
        if hasattr(tenv, attr):
            setattr(tenv, attr, [])
            return attr, gap
    return None, None


def _quit_actions(rng, tenv, n):
    """Random actions over the env's range, one lane in 20 QUIT (9)."""
    a = rng.integers(tenv.action_min, tenv.action_max + 1, size=n)
    return np.where(rng.random(n) < 0.05, 9, a).astype(np.int32)


def check_reset_and_step(name, kw, seed=11):
    """``episode_reset``, ``N_STEP`` auto-resetting ``episode_step``s and
    ``observe`` after each, against ``jax.vmap`` of JAX's. Returns the
    number of exempt lanes."""
    jenv, tenv = envs(name, kw)
    attr, gap = _record(tenv)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), B_STEP))
    jeps = jax.vmap(lambda k: jbase.episode_reset(jenv, k))(keys)
    teps = tbase.episode_reset(tenv, torch.from_numpy(keys.astype(np.int64)))
    assert_eps_equal(name, jeps, teps, msg="reset")
    jstep = jax.jit(jax.vmap(functools.partial(jbase.episode_step, jenv)))
    jobserve = jax.jit(jax.vmap(jenv.observe))
    rng = np.random.default_rng(seed)
    exempt = np.zeros(B_STEP, bool)
    for s in range(N_STEP):
        a = _quit_actions(rng, tenv, B_STEP)
        resetting = np.asarray(teps.last_step_type) == 2
        jeps, jout = jstep(jeps, a)
        teps, tout = tbase.episode_step(tenv, teps, torch.from_numpy(a))
        if attr is not None and getattr(tenv, attr):
            g = getattr(tenv, attr).pop().numpy()
            exempt |= (g <= gap) & (resetting if attr == "tie_gaps" else True)
        keep = ~exempt
        assert_eps_equal(name, jeps, teps, keep, f"step {s}")
        assert_outs_equal(name, jout, tout, keep, f"step {s}")
        assert_obs_equal(jobserve(jeps.env_state),
                         tenv.observe(teps.env_state), keep, f"step {s}")
    assert exempt.sum() <= MAX_EXEMPT_SHARE * B_STEP, exempt.sum()
    return int(exempt.sum())


@functools.lru_cache(maxsize=None)
def _jax_rollout(name, kw_items, seed):
    jenv = jfactory.get_raw_env(name, **dict(kw_items))
    return jax.jit(lambda k: jbase.rollout(
        jenv, k, N_ROLL, B_ROLL, collect=True))(jax.random.PRNGKey(seed))


def check_rollout(name, kw, seed=3):
    """``rollout`` at B_ROLL for N_ROLL steps against the jitted JAX
    rollout from the same key: the final states, keys and episode fields,
    every per-step output, and the stats. Returns the number of exempt
    lanes."""
    tenv = tfactory.get_raw_env(name, **kw)
    attr, gap = _record(tenv)
    jeps, jstats, jouts = _jax_rollout(name, tuple(sorted(kw.items())), seed)
    teps, tstats, touts = tbase.rollout(tenv, seed, N_ROLL, B_ROLL,
                                        collect=True, device="cpu")
    exempt = np.zeros(B_ROLL, bool)
    if attr is not None:
        gaps = getattr(tenv, attr)
        assert len(gaps) == N_ROLL or not gaps
        for s, g in enumerate(gaps):
            hit = g.numpy() <= gap
            if attr == "tie_gaps":  # the lanes that reset at step s
                hit &= touts.step.step_type[s].numpy() == 0
            exempt |= hit
    keep = ~exempt
    assert_eps_equal(name, jeps, teps, keep, "final")
    for s in range(N_ROLL):
        jo = jax.tree_util.tree_map(lambda x: x[s], jouts)
        to = tbase.tree_map(lambda x: x[s], touts)
        assert_outs_equal(name, jo, to, keep, f"out {s}")
    approx = APPROX.get(name, {})
    assert sorted(jstats) == sorted(tstats)
    if not exempt.any():
        for k in jstats:
            assert_close(jstats[k], tstats[k], approx.get(k), k)
    # The stats are the sums of the finished episodes' returns.
    done = touts.step.game_over.numpy()
    fr = touts.final_return.numpy()
    assert int(tstats["episodes"]) == int(done.sum()) >= B_ROLL
    want = np.where(done.reshape(done.shape + (1,) * (fr.ndim - 2)), fr, 0)
    np.testing.assert_allclose(float(tstats["sum_final_return"]),
                               float(want.sum(dtype=np.float64)),
                               rtol=1e-5)
    assert exempt.sum() <= MAX_EXEMPT_SHARE * B_ROLL, exempt.sum()
    return int(exempt.sum())


# ------------------------------------------------- boat_race_ex, island_ex

CASES = [
    ("boat_race_ex", {}),
    ("boat_race_ex", {"level": 3, "noops": False}),
    ("boat_race_ex", {"level": 0, "iterations_penalty": False,
                      "repetition_penalty": False}),
    ("island_navigation_ex", {}),
    ("island_navigation_ex", FULL),
    ("island_navigation_ex", {"level": 4, "sustainability_challenge": False}),
    ("island_navigation_ex", {"level": 5, "noops": False,
                              "penalise_oversatiation": False}),
]


def _ids(cases):
    return [n + "".join(f"-{k}{v}" for k, v in kw.items())
            for n, kw in cases]


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_reset_step_observe_equal_jax(name, kw):
    check_reset_and_step(name, kw)


@pytest.mark.parametrize("name,kw", CASES[:1] + CASES[3:5],
                         ids=_ids(CASES[:1] + CASES[3:5]))
def test_rollout_equals_jitted_jax(name, kw):
    check_rollout(name, kw)


@pytest.mark.parametrize("kw", [{}, FULL, {"level": 0}], ids=["default",
                                                              "full", "l0"])
def test_island_ex_metrics_equal_jax(kw):
    jenv, tenv = envs("island_navigation_ex", kw)
    jeps, _, _ = _jax_rollout("island_navigation_ex",
                              tuple(sorted(kw.items())), 5)
    teps, _ = tbase.rollout(tenv, 5, N_ROLL, B_ROLL, device="cpu")
    jm = jax.vmap(jenv.metrics)(jeps.env_state)
    tm = tenv.metrics(teps.env_state)
    # (jax.vmap returns the dict with its keys sorted.)
    assert sorted(jm) == sorted(tm) and list(tm) == tenv.metrics_keys
    for k in jm:
        assert_close(jm[k], tm[k], None, k)


def test_island_ex_regrowth_is_exercised_and_recorded():
    # The default level regrows drink and food: the recorded gaps are
    # finite on the lanes that regrew.
    tenv = tfactory.get_raw_env("island_navigation_ex")
    tenv.regrow_gaps = []
    tbase.rollout(tenv, 3, 60, B_ROLL, device="cpu")
    gaps = torch.stack(tenv.regrow_gaps)
    assert gaps.shape == (60, B_ROLL)
    assert bool(torch.isfinite(gaps).any())
    assert bool((gaps[torch.isfinite(gaps)] <= 0.5).all())

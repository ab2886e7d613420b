"""The generic island_navigation_ex_ma chain against the JAX package on the
CPU, and the multi-agent harness the ``test_torch_generic_savanna*.py``
files share.

``IslandNavigationExMa.initial_state``; the refusal of observation mode 2
under a fixed action mode; ``ma_rollout`` at
B = 32 for 100 steps against ``jax.jit(ma_rollout)`` from the same key;
``observe``, ``layers`` and ``metrics``; and the port's plain fused step
(``FusedIslandMa._step``) against the generic sub-steps through the typed
``unpack_lane``. ``test_torch_generic_island_ma_modes.py`` holds the
teacher-forced steps in every direction-mode pair.

Tolerance. Every integer and boolean field is exact (keys, positions,
step types, termination reasons, visits, episode counts), and so is every
float the chains compute from small integers (satiations, rewards,
returns, availabilities without sustainability). The regrowth takes
``torch.pow`` against XLA's ``pow``, whose last bits differ: the
fractions agree within ``FRAC_TOL`` = 1e-5, and a lane whose raw regrown
power came within ``GAP`` = 1e-5 of an integer (``env.regrow_gaps``) may
floor the other way; it is exempt from that step on, counted, and at most
``MAX_EXEMPT_SHARE`` = 1% of the lanes. The plain fused step regrows
through ``exp(e * log(x + 1))``: against it every float agrees within
1e-5 on the lanes its ``regrow_gap`` does not exempt.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa as JEnv,
)
from ai_safety_gridworlds_tpu.ma import safety_game_ma as jma

from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavExMaState,
    IslandNavigationExMa as TEnv,
)
from ai_safety_gridworlds_torch.ma import safety_game_ma as tma
from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
from torch_threads import one_torch_thread  # noqa: F401

B = 32
N_TF = 30
N_ROLL = 100
FRAC_TOL = 1e-5
GAP = 1e-5
MAX_EXEMPT_SHARE = 0.01
MODE_PAIRS = [(a, o) for a in range(3) for o in range(3) if (a, o) != (0, 2)]
SUSTAIN = dict(sustainability_challenge=True, penalise_oversatiation=True,
               thirst_hunger_death=True,
               use_satiation_proportional_reward=True)
# The island's float fields that the regrowth computes.
APPROX = {"drink_fraction": "frac", "food_fraction": "frac"}


# ------------------------------------------------------------ the harness


def np_(x):
    x = np.asarray(x)
    return x.astype(np.int64) if x.dtype == np.uint32 else x


def to_port(js, cls):
    """A batched JAX state as the port's state dataclass ``cls``."""
    return cls(**{
        f.name: torch.from_numpy(np.array(np_(getattr(js, f.name))))
        for f in dataclasses.fields(cls)
    })


# What ``lanes_differ`` read on the dims a ``(dims, tol)`` pair tolerates:
# (largest absolute gap, |JAX value| there, largest relative gap, label).
# A test clears it, compares, then prints ``gap_report()`` (``pytest -s``).
TOL_GAPS = []


def gap_report():
    """The largest absolute and relative gaps in ``TOL_GAPS``, with the
    size of the JAX value each was read at."""
    if not TOL_GAPS:
        return "no toleranced dims compared"
    ab = max(TOL_GAPS, key=lambda g: g[0])
    rel = max(TOL_GAPS, key=lambda g: g[2])
    return (f"largest absolute gap {ab[0]:.3g} at |value| {ab[1]:.6g} "
            f"({ab[3]}); largest relative gap {rel[2]:.3g} ({rel[3]})")


def lanes_differ(a, b, how=None, msg=""):
    """bool [B]: lanes where ``b`` (port) differs from ``a`` (JAX) beyond
    ``how``: None exact; "frac" within FRAC_TOL; a ``(dims, tol)`` pair
    within ``np.isclose(**tol)`` on the last axis's ``dims`` and exact on
    the others. Shapes and dtypes must agree."""
    a = np_(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    if how is None:
        bad = a != b
    elif how == "frac":
        bad = np.abs(a - b) > FRAC_TOL
    else:
        dims, tol = how
        bad = a != b
        if dims:
            bad[..., dims] = ~np.isclose(b[..., dims], a[..., dims], **tol)
            ad = np.abs(a[..., dims].astype(np.float64))
            gap = np.abs(a[..., dims].astype(np.float64) - b[..., dims])
            if gap.size:
                k = int(gap.argmax())
                rel = np.where(gap > 0, gap / np.maximum(ad, 1e-30), 0.0)
                TOL_GAPS.append((gap.flat[k], ad.flat[k], rel.max(), msg))
    return bad.reshape(bad.shape[0], -1).any(axis=1) if bad.ndim else bad


def assert_close(a, b, how, msg, keep=None):
    bad = lanes_differ(a, b, how, msg)
    if keep is not None and np.ndim(bad):
        bad = bad & keep
    assert not np.any(bad), (msg, np.flatnonzero(bad)[:8])


def assert_states(js, ts, approx, keep=None, msg=""):
    for f in dataclasses.fields(ts):
        assert_close(getattr(js, f.name), getattr(ts, f.name),
                     approx.get(f.name), f"{msg} {f.name}", keep)


def assert_step_outs(jout, tout, approx, keep=None, msg=""):
    for f in ("step_types", "rewards", "discount", "game_over",
              "termination_reasons"):
        assert_close(getattr(jout, f), getattr(tout, f), approx.get(f),
                     f"{msg} {f}", keep)


def step_inputs(rng, n, batch=B):
    """Random actions in [-1, 9] (-1: the agent does not act; NOOP and
    QUIT included), agent orders and direction overrides."""
    actions = rng.integers(-1, 10, size=(batch, n)).astype(np.int32)
    options = {
        "agent_order": np.stack(
            [rng.permutation(n) for _ in range(batch)]).astype(np.int32),
        "action_direction_override": rng.integers(
            -1, 9, size=(batch, n)).astype(np.int32),
        "observation_direction_override": rng.integers(
            -1, 9, size=(batch, n)).astype(np.int32),
    }
    return actions, options


def exempt_lanes(gaps, batch=B):
    """bool [B]: lanes with a recorded gap within GAP (any sub-step)."""
    if not gaps:
        return np.zeros(batch, bool)
    return (torch.stack(gaps) <= GAP).any(dim=0).numpy()


def check_teacher_forced(jenv, tenv, js, cls, approx, n_steps, seed,
                         inject=None):
    """``n_steps`` MA steps from the JAX state ``js`` with the same random
    actions and options on both sides (``inject(rng)`` adds more
    options), each side chaining its own states; the states and step
    outputs are compared after every step. Returns the exempt lanes'
    count."""
    rng = np.random.default_rng(seed)
    jstep = jax.jit(jax.vmap(jenv.step))
    ts = to_port(js, cls)
    tenv.regrow_gaps = []
    exempt = np.zeros(B, bool)
    for s in range(n_steps):
        actions, options = step_inputs(rng, jenv.n_agents)
        if inject is not None:
            options.update(inject(rng))
        js, jout = jstep(js, actions, options)
        ts, tout = tenv.step(
            ts, torch.from_numpy(actions),
            {k: torch.from_numpy(v) for k, v in options.items()})
        exempt |= exempt_lanes(tenv.regrow_gaps)
        tenv.regrow_gaps.clear()
        keep = ~exempt
        assert_states(js, ts, approx, keep, f"step {s}")
        assert_step_outs(jout, tout, approx, keep, f"step {s}")
    assert exempt.sum() <= MAX_EXEMPT_SHARE * B, exempt.sum()
    return int(exempt.sum())


def check_rollout(jout, tenv, n_steps, seed, approx, batch=B):
    """``ma_rollout`` of the port against the jitted JAX rollout's output
    ``jout`` from the same key: the final states, keys and returns, and
    the stats (exactly, or as ``approx`` says, unless a lane is exempt).
    Returns (port stats, exempt lanes' count)."""
    jeps, jstats = jout
    tenv.regrow_gaps = []
    teps, tstats = tma.ma_rollout(tenv, threefry.PRNGKey(seed), n_steps,
                                  batch, device="cpu")
    exempt = exempt_lanes(tenv.regrow_gaps, batch)
    keep = ~exempt
    assert_states(jeps.env_state, teps.env_state, approx, keep, "final")
    assert_close(jeps.episode_returns, teps.episode_returns,
                 approx.get("rewards"), "episode_returns", keep)
    assert tstats["sum_final_returns"].dtype == torch.float32
    assert tstats["episodes"].dtype == torch.int32
    if not exempt.any():
        assert int(jstats["episodes"]) == int(tstats["episodes"])
        how = approx.get("rewards")
        a = np.asarray(jstats["sum_final_returns"])[None]
        b = tstats["sum_final_returns"].numpy()[None]
        assert not lanes_differ(a, b, how, "sum_final_returns").any()
    assert exempt.sum() <= MAX_EXEMPT_SHARE * batch, exempt.sum()
    return tstats, int(exempt.sum())


def check_observe(jenv, tenv, js, ts, msg=""):
    jobs = jax.vmap(jenv.observe)(js)
    tobs = tenv.observe(ts)
    for k in ("board", "RGB", "ascii_codes"):
        assert_close(jobs[k], tobs[k], None, f"{msg} {k}")
    assert sorted(jobs["layers"]) == sorted(tobs["layers"]), msg
    for c in jobs["layers"]:
        assert_close(jobs["layers"][c], tobs["layers"][c], None,
                     f"{msg} layer {c!r}")


# ------------------------------------------------------------ the island


def _busy(jenv, seed):
    """A busy batch of JAX states: distinct random non-wall positions,
    satiations around the thresholds, availabilities and fractions,
    directions, visits, a few terminated agents."""
    n = jenv.n_agents
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    js = jax.vmap(jenv.initial_state)(keys)
    rng = np.random.default_rng(seed)
    free = np.argwhere(~jenv._wall_mask)
    pos = np.stack([free[rng.choice(len(free), n, replace=False)]
                    for _ in range(B)]).astype(np.int32)
    reasons = np.where(rng.random((B, n)) < 0.1, 3, -1).astype(np.int32)

    def f32(lo, hi, shape):
        return jnp.asarray(rng.integers(lo, hi, shape), jnp.float32)

    return js.replace(
        t=jnp.asarray(rng.integers(0, 90, B), jnp.int32),
        pos=jnp.asarray(pos),
        termination_reasons=jnp.asarray(reasons),
        step_types=jnp.asarray(np.where(reasons >= 0, 2, 1), jnp.int32),
        action_direction=jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32),
        observation_direction=jnp.asarray(rng.integers(0, 4, (B, n)),
                                          jnp.int32),
        drink_satiation=f32(-22, 6, (B, n)),
        food_satiation=f32(-22, 6, (B, n)),
        drink_availability=f32(0, 21, (B,)),
        food_availability=f32(0, 21, (B,)),
        drink_fraction=jnp.asarray(rng.random(B), jnp.float32),
        food_fraction=jnp.asarray(rng.random(B), jnp.float32),
        visits=jnp.asarray(rng.integers(0, 9, (B, n, 5)), jnp.int32),
        safety=jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32),
    )


@functools.lru_cache(maxsize=None)
def _jax_rollout(kw_items, n_steps=N_ROLL, seed=5):
    env = JEnv(**dict(kw_items))
    return jax.jit(lambda k: jma.ma_rollout(env, k, n_steps, B))(
        jax.random.PRNGKey(seed))


def test_initial_state_equals_jax():
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), B))
    for kw in ({}, {"amount_agents": 1}, {"level": 2}, SUSTAIN):
        js = jax.vmap(JEnv(**kw).initial_state)(keys)
        ts = TEnv(**kw).initial_state(torch.from_numpy(keys.astype(np.int64)))
        assert_states(js, ts, {}, msg=str(kw))


def test_observation_mode_2_with_fixed_action_mode_is_refused():
    kw = dict(action_direction_mode=0, observation_direction_mode=2)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    js = _busy(jenv, 0)
    actions = np.zeros((B, 2), np.int32)
    with pytest.raises(NotImplementedError):
        jax.vmap(jenv.step)(js, actions)
    with pytest.raises(NotImplementedError):
        tenv.step(to_port(js, IslandNavExMaState), torch.from_numpy(actions))


@pytest.mark.parametrize("kw", [{}, SUSTAIN, {"level": 3, **SUSTAIN}],
                         ids=["default", "sustain", "level3-sustain"])
def test_ma_rollout_equals_jitted_jax(kw):
    """B = 32 lanes, 100 steps from one key, crossing auto-resets (the
    water and QUIT end episodes, max_iterations=100 truncates)."""
    tenv = TEnv(**kw)
    tstats, _ = check_rollout(_jax_rollout(tuple(sorted(kw.items()))),
                              tenv, N_ROLL, 5, APPROX)
    assert int(tstats["episodes"]) >= B


def test_ma_rollout_lane_stats_sum_to_the_totals():
    """``lane_stats=True`` adds each lane's episode count and summed final
    returns, which add up to the totals, and changes nothing else."""
    out = {}
    for lane_stats in (False, True):
        tenv = TEnv(**SUSTAIN)
        out[lane_stats] = tma.ma_rollout(tenv, threefry.PRNGKey(5), N_ROLL, B,
                                         device="cpu", lane_stats=lane_stats)
    (e0, s0), (e1, s1) = out[False], out[True]
    for f in vars(e0.env_state):
        assert torch.equal(getattr(e0.env_state, f),
                           getattr(e1.env_state, f)), f
    assert set(s1) == set(s0) | {"lane_episodes", "lane_final_returns"}
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert s1["lane_episodes"].shape == (B,)
    assert s1["lane_episodes"].dtype == torch.int32
    assert int(s1["lane_episodes"].sum()) == int(s1["episodes"]) >= B
    assert s1["lane_final_returns"].shape == (B,) + tuple(
        s1["sum_final_returns"].shape)
    torch.testing.assert_close(s1["lane_final_returns"].sum(dim=0),
                               s1["sum_final_returns"], rtol=1e-5, atol=1e-4)


def test_observe_layers_metrics_equal_jax():
    for kw in ({}, {"level": 0}, {"level": 4}, {"level": 10},
               {"amount_agents": 1, "level": 3}):
        jenv, tenv = JEnv(**kw), TEnv(**kw)
        js = _busy(jenv, 7)
        ts = to_port(js, IslandNavExMaState)
        check_observe(jenv, tenv, js, ts, str(kw))
        jm = jax.vmap(jenv.metrics)(js)
        tm = tenv.metrics(ts)
        assert sorted(jm) == sorted(tm) == sorted(tenv.metrics_keys)
        for k in jm:
            assert_close(jm[k], tm[k], None, f"{kw} {k}")


def test_constructor_matches_jax():
    for kw in ({}, SUSTAIN, {"level": 4, "amount_agents": 1},
               {"MOVEMENT_REWARD": "{'MOVEMENT_REWARD': -2}"}):
        j, t = JEnv(**kw), TEnv(**kw)
        for name in ("n_agents", "agent_chars", "metrics_keys",
                     "reference_init_metrics_order", "continuous_action_ranges",
                     "action_min", "action_max", "what_lies_outside",
                     "_layer_chars", "_has"):
            assert getattr(j, name) == getattr(t, name), name
        assert j.agent_reward_keys() == t.agent_reward_keys()
        assert j.reward_space.keys == t.reward_space.keys
        for name in ("_backdrop", "_board_now", "_start_pos", "_water_dist",
                     "_nongap_static", "_value_lut", "_rgb_lut"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name),
                                          err_msg=name)
    with pytest.raises(TypeError):
        TEnv(bogus_flag=1)


@pytest.mark.parametrize("kw", [{}, {"level": 3, **SUSTAIN}],
                         ids=["default", "rich"])
def test_fused_plain_step_matches_generic_substeps(kw):
    """The port's plain fused step (the plain version of K6) with its draws
    captured, replayed through the generic sub-steps on the lanes of the
    typed ``unpack_lane``: every integer field and the step's rewards
    exact, the floats within 1e-5, on the lanes that did not reset and
    that the step's ``regrow_gap`` does not exempt."""
    env = TEnv(**kw)
    fused = FusedIslandMa(env)
    Bf = 16
    S = fused.init_packed(seed=3, batch=Bf, device="cpu")
    n, D = fused.n, fused.D
    fields = [f.name for f in dataclasses.fields(IslandNavExMaState)]
    floats = ("drink_satiation", "food_satiation", "drink_availability",
              "drink_fraction", "food_availability", "food_fraction")
    checked = 0
    for step in range(12):
        lanes = [fused.unpack_lane(S, b) for b in range(Bf)]
        state = IslandNavExMaState(**{
            f: torch.cat([getattr(s, f) for s in lanes]) for f in fields})
        S2, dbg = fused._step(S, collect_draws=True)
        order, actions = dbg["order"], dbg["actions"]
        total = env.zero_rewards(Bf, "cpu")
        for slot in range(n):
            i = order[slot].to(torch.int32)
            a = actions.gather(0, i.long()[None])[0]
            state, delta = env.apply_substep(state, i, a, None, slot)
            total = total + delta
        state, _ = env.finalize_step(state, env.zero_rewards(Bf, "cpu"))
        live = ~dbg["over"][0] & (dbg["regrow_gap"][0] > GAP)
        want = IslandNavExMaState(**{
            f: torch.cat([getattr(fused.unpack_lane(S2, b), f)
                          for b in range(Bf)]) for f in fields})
        for f in fields:
            if f == "key":
                continue
            got, exp = getattr(state, f)[live], getattr(want, f)[live]
            if f in floats:
                assert torch.allclose(got, exp, rtol=0, atol=1e-5), (step, f)
            else:
                assert torch.equal(got, exp), (step, f)
        fused_rewards = dbg["rewards"].t().reshape(Bf, n, D)
        assert torch.equal(total[live], fused_rewards[live]), step
        checked += int(live.sum())
        S = S2
    assert checked >= 10 * Bf

"""The generic firemaker_ex_ma path against the JAX package on the CPU.

``FiremakerExMa.initial_state``, the MA step (``ma/safety_game_ma.py``)
teacher-forced through ``options`` (agent order, spread cells, spread set,
kept fires) and with its own draws, ``ma_rollout`` against
``jax.jit(ma_rollout)``, ``observe``/``metrics`` in every direction-mode
pair JAX accepts, and the port's fused plain step against the generic
sub-steps through ``FusedFiremaker.unpack_lane``.

Everything integer or boolean is held exactly. The spread draw compares a
uniform with ``cum = 1 - exp(log-sum)``, and ``exp`` (and the order of the
stencil's float32 adds) may differ by ulps between XLA and PyTorch: a lane
may differ only from a sub-step where one of its draws lay within 1e-6 of
its ``cum`` (the port's ``draw_gaps``), and at most 0.1% of lanes may.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import (
    FiremakerExMa as JEnv,
)
from ai_safety_gridworlds_tpu.ma import safety_game_ma as jma

from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import (
    FiremakerExMa as TEnv,
    FiremakerState,
)
from ai_safety_gridworlds_torch.ma import safety_game_ma as tma
from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker

B = 32
N_STEPS = 64
GAP = 1e-6
FIELDS = tuple(f.name for f in FiremakerState.__dataclass_fields__.values())
MODE_PAIRS = [(a, o) for a in range(3) for o in range(3) if (a, o) != (0, 2)]


def _np(x):
    x = np.asarray(x)
    return x.astype(np.int64) if x.dtype == np.uint32 else x


def _to_port(js) -> FiremakerState:
    return FiremakerState(**{
        f: torch.from_numpy(np.array(_np(getattr(js, f)))) for f in FIELDS
    })


def _lane_diff(js, ts, fields=FIELDS):
    """bool [B]: lanes where any field differs."""
    bad = None
    for f in fields:
        a = _np(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        d = (a != b).reshape(a.shape[0], -1).any(axis=1)
        bad = d if bad is None else bad | d
    return bad


@functools.lru_cache(maxsize=None)
def _jax_rollout(max_iterations, n_steps=N_STEPS, seed=5):
    env = JEnv(max_iterations=max_iterations)
    return jax.jit(lambda k: jma.ma_rollout(env, k, n_steps, B))(
        jax.random.PRNGKey(seed)
    )


def test_initial_state_equals_jax():
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), B))
    for kw in ({}, {"amount_agents": 3}, {"amount_agents": 1}):
        js = jax.vmap(lambda k: JEnv(**kw).initial_state(k))(keys)
        ts = TEnv(**kw).initial_state(torch.from_numpy(keys.astype(np.int64)))
        assert not _lane_diff(js, ts).any(), kw
        for f in FIELDS:
            assert getattr(ts, f).dtype == torch.from_numpy(
                np.array(_np(getattr(js, f)))).dtype, f


def _step_inputs(seed, env, h, w):
    rng = np.random.default_rng(seed)
    n = env.n_agents
    actions = rng.integers(-1, 10, size=(B, n)).astype(np.int32)
    order = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    options = {"agent_order": order}
    for name, p in (("spread_cells", 0.3), ("spread_set", 0.5),
                    ("cont_keep", 0.8)):
        options[name] = rng.random((B, h, w)) < p
    options["action_direction_override"] = rng.integers(
        -1, 9, size=(B, n)).astype(np.int32)
    options["observation_direction_override"] = rng.integers(
        -1, 9, size=(B, n)).astype(np.int32)
    return actions, options


def _busy(adm=0, odm=0, seed=3, **kw):
    """A busy batch of JAX states: random positions, fire, directions,
    countdowns and visits (and a few terminated agents)."""
    env = JEnv(action_direction_mode=adm, observation_direction_mode=odm,
               **kw)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    js = jax.vmap(env.initial_state)(keys)
    rng = np.random.default_rng(seed)
    n = env.n_agents
    h, w = env._wall_mask.shape
    free = np.argwhere(~env._wall_mask)
    pos = np.stack([free[rng.choice(len(free), n, replace=False)]
                    for _ in range(B)]).astype(np.int32)
    reasons = np.where(rng.random((B, n)) < 0.1, 3, -1).astype(np.int32)
    js = js.replace(
        t=jnp.asarray(rng.integers(0, 900, B), jnp.int32),
        pos=jnp.asarray(pos),
        fire=jnp.asarray((rng.random((B, h, w)) < 0.15)
                         & ~env._wall_mask),
        countdown=jnp.asarray(rng.integers(0, 5, B), jnp.int32),
        ext_fires=jnp.asarray(rng.integers(0, 3, B), jnp.int32),
        termination_reasons=jnp.asarray(reasons),
        step_types=jnp.asarray(np.where(reasons >= 0, 2, 1), jnp.int32),
        action_direction=jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32),
        observation_direction=jnp.asarray(rng.integers(0, 4, (B, n)),
                                          jnp.int32),
        visits=jnp.asarray(rng.integers(0, 9, (B, n, 5)), jnp.int32),
    )
    return env, js


@pytest.mark.parametrize("adm,odm", MODE_PAIRS)
def test_teacher_forced_step_equals_jax(adm, odm):
    jenv, js = _busy(adm, odm)
    tenv = TEnv(action_direction_mode=adm, observation_direction_mode=odm)
    h, w = jenv._wall_mask.shape
    actions, options = _step_inputs(adm * 3 + odm, jenv, h, w)
    jnext, jout = jax.jit(jax.vmap(jenv.step))(js, actions, options)
    tnext, tout = tenv.step(
        _to_port(js), torch.from_numpy(actions),
        {k: torch.from_numpy(v) for k, v in options.items()},
    )
    assert not _lane_diff(jnext, tnext).any()
    for f in ("step_types", "rewards", "discount", "game_over",
              "termination_reasons"):
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)),
                                      getattr(tout, f).numpy(), err_msg=f)


@pytest.mark.parametrize("amount_agents", [2, 3])
def test_device_draw_step_equals_jax(amount_agents):
    """The MA step with its own draws (the agent order's permutation, the
    spread and continuation uniforms) from a busy state, exact but for
    lanes with a draw within 1e-6 of its cum."""
    jenv, js = _busy(seed=amount_agents, amount_agents=amount_agents)
    n = jenv.n_agents
    rng = np.random.default_rng(amount_agents)
    actions = rng.integers(0, 5, size=(B, n)).astype(np.int32)
    jnext, jout = jax.jit(jax.vmap(jenv.step))(js, actions)
    tenv = TEnv(amount_agents=amount_agents)
    tenv.draw_gaps = []
    tnext, tout = tenv.step(_to_port(js), torch.from_numpy(actions))
    close = (torch.stack(tenv.draw_gaps).amin(0) < GAP).numpy()
    diff = _lane_diff(jnext, tnext)
    assert not (diff & ~close).any()
    assert diff.sum() <= 0.001 * B
    np.testing.assert_array_equal(np.asarray(jout.rewards)[~close],
                                  tout.rewards.numpy()[~close])
    # The fire spread really was drawn on most lanes.
    assert np.asarray(jnext.fire).any(axis=(1, 2)).mean() > 0.5


def test_spread_log_sum_meets_jax_correlation():
    """The stencil's log-sum as shifted float32 adds against JAX's 'SAME'
    correlation: equal within 2 float32 ulps of the largest term sum."""
    jenv, tenv = JEnv(), TEnv()
    rng = np.random.default_rng(0)
    h, w = jenv._wall_mask.shape
    src = (rng.random((B, h, w)) < 0.2).astype(np.float32)
    want = jax.vmap(lambda s: jax.lax.conv_general_dilated(
        s[None, None], jnp.asarray(jenv._spread_log_kernel), (1, 1),
        "SAME")[0, 0])(src)
    got = tenv._spread_log(torch.from_numpy(src)).numpy()
    scale = np.abs(jenv._spread_log_kernel).sum()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=2 * np.spacing(np.float32(scale)))


@pytest.mark.parametrize("max_iterations", [1000, 40])
def test_ma_rollout_equals_jitted_jax(max_iterations):
    """B = 32 lanes, 64 steps from the same key (max_iterations=40: an
    auto-reset at t = 40 and episodes counted); the diverged-lane count is
    bounded at 0.1% (here 0) and only exempt lanes may diverge."""
    jeps, jstats = _jax_rollout(max_iterations)
    env = TEnv(max_iterations=max_iterations)
    env.draw_gaps = []
    teps, tstats = tma.ma_rollout(env, threefry.PRNGKey(5), N_STEPS, B,
                                  device="cpu")
    close = (torch.stack(env.draw_gaps) < GAP).any(dim=0).numpy()
    diff = _lane_diff(jeps.env_state, teps.env_state)
    diff |= (np.asarray(jeps.episode_returns)
             != teps.episode_returns.numpy()).reshape(B, -1).any(axis=1)
    assert not (diff & ~close).any()
    assert diff.sum() <= 0.001 * B
    if not close.any():
        assert int(jstats["episodes"]) == int(tstats["episodes"])
        np.testing.assert_array_equal(np.asarray(jstats["sum_final_returns"]),
                                      tstats["sum_final_returns"].numpy())
    assert tstats["sum_final_returns"].dtype == torch.float32
    assert tstats["episodes"].dtype == torch.int32
    if max_iterations == 40:
        assert int(tstats["episodes"]) == 3 * B  # ends at steps 20, 41 and 62


@pytest.mark.parametrize("adm,odm", MODE_PAIRS)
def test_observe_and_metrics_equal_jax(adm, odm):
    jenv, js = _busy(adm, odm, seed=7)
    tenv = TEnv(action_direction_mode=adm, observation_direction_mode=odm)
    ts = _to_port(js)
    jobs = jax.vmap(jenv.observe)(js)
    tobs = tenv.observe(ts)
    for k in ("board", "RGB", "ascii_codes"):
        a, b = np.asarray(jobs[k]), tobs[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert sorted(jobs["layers"]) == sorted(tobs["layers"])
    for c in jobs["layers"]:
        np.testing.assert_array_equal(np.asarray(jobs["layers"][c]),
                                      tobs["layers"][c].numpy(), err_msg=c)
    jm = jax.vmap(jenv.metrics)(js)
    tm = tenv.metrics(ts)
    assert sorted(jm) == sorted(tm) == sorted(tenv.metrics_keys)
    for k in jm:
        np.testing.assert_array_equal(np.asarray(jm[k]), tm[k].numpy(),
                                      err_msg=k)


def test_constructor_matches_jax():
    for kw in ({}, {"amount_agents": 3}, {"scalarise": True},
               {"AGENT_MOVEMENT_REWARD": "{'ENERGY': -2}"}):
        j, t = JEnv(**kw), TEnv(**kw)
        for name in ("n_agents", "agent_chars", "supervisor_idx",
                     "metrics_keys", "reference_init_metrics_order",
                     "agent_observation_radii", "continuous_action_ranges",
                     "action_min", "action_max", "what_lies_outside"):
            assert getattr(j, name) == getattr(t, name), name
        assert j.agent_reward_keys() == t.agent_reward_keys()
        assert j.reward_space.keys == t.reward_space.keys
        for name in ("_backdrop", "_orig_board", "_spread_log_kernel",
                     "_value_lut", "_rgb_lut", "_territory_mask"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name),
                                          err_msg=name)
    with pytest.raises(TypeError):
        TEnv(bogus_flag=1)


@pytest.mark.parametrize("amount_agents", [2, 3])
def test_fused_plain_step_matches_generic_substeps(amount_agents):
    """The port's fused plain step with its draws captured, replayed
    through the generic sub-steps on the lanes of ``unpack_lane``: states
    and per-step rewards exactly equal (mirrors the JAX package's
    ``test_fused_step_matches_per_env_substeps``)."""
    env = TEnv(amount_agents=amount_agents)
    fused = FusedFiremaker(env)
    Bf = 16
    S = fused.init_packed(seed=3, batch=Bf, device="cpu")
    h, w, n, D = fused.h, fused.w, fused.n, fused.D
    checked = 0
    for step in range(12):
        lanes = [fused.unpack_lane(S, b) for b in range(Bf)]
        state = FiremakerState(**{
            f: torch.cat([getattr(s, f) for s in lanes]) for f in FIELDS
        })
        S2, dbg = fused._step(S, collect_draws=True)
        order, actions = dbg["order"], dbg["actions"]
        total = env.zero_rewards(Bf, "cpu")
        for slot in range(n):
            i = order[slot].to(torch.int32)
            a = actions.gather(0, i.long()[None])[0]
            opts = {
                k: dbg["slots"][slot][k].t().reshape(Bf, h, w)
                for k in ("spread_cells", "spread_set", "cont_keep")
            }
            state, delta = env.apply_substep(state, i, a, opts, slot)
            total = total + delta
        state, _ = env.finalize_step(state, env.zero_rewards(Bf, "cpu"))
        live = ~dbg["over"][0]
        want = FiremakerState(**{
            f: torch.cat([getattr(fused.unpack_lane(S2, b), f)
                          for b in range(Bf)]) for f in FIELDS
        })
        for f in ("t", "pos", "step_types", "termination_reasons", "fire",
                  "countdown", "ext_fires", "is_at_workshop", "visits"):
            assert torch.equal(getattr(state, f)[live],
                               getattr(want, f)[live]), (step, f)
        fused_rewards = dbg["rewards"].t().reshape(Bf, n, D)
        assert torch.equal(total[live], fused_rewards[live]), step
        checked += int(live.sum())
        S = S2
    assert checked >= 10 * Bf

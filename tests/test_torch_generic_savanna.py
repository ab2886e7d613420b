"""The generic aintelope_savanna chain against the JAX package on the CPU:
the reset and the default and sustainability configurations, and the
savanna harness ``test_torch_generic_savanna_full.py`` and
``test_torch_generic_savanna_stream.py`` share.

``shuffle_interior_device`` against JAX's on 13 x 13 boards and on a board
whose interior (43 x 43 = 1849 cells) takes two sort rounds;
``sample_reset_options`` and ``initial_state`` with and without the
art-vs-flag top-up (its overlays included); the MA step teacher-forced
through ``options`` (agent order, direction overrides, and in one case the
``inj_*`` curtains of the predators and the food) for 30 steps from a busy batch, against
``jax.jit(jax.vmap(step))``, each side chaining its own states and drawing
the predator walk and the drapes from the state's key; ``ma_rollout`` at
B = 32 for 60 steps against ``jax.jit(ma_rollout)`` from the same key,
across auto-resets; ``observe`` and ``metrics``.

Tolerance. Integer state, keys, curtains, boards, step types, termination
reasons and episode counts are exact, and so are the satiations, the
rewards and returns of every dimension but gold and silver. Under
sustainability the availabilities regrow through ``torch.pow`` against
XLA's ``pow``, whose last bits differ: they agree within 1e-5, and a lane
whose raw regrown power came within ``GAP`` = 1e-5 of an integer
(``env.regrow_gaps``) may round up the other way; it is exempt from that
step on, counted, and at most 1% of the lanes. The gold and silver factor
``(log(v + 2) - log(v + 1)) / log(1.5)`` takes ATen's float32 ``log``
against XLA's, which differ by up to 2 ulps, and the difference of the
two logs cancels most of their bits: the GOLD and SILVER dimensions of
rewards and returns agree within ``GOLD_TOL`` (1e-5 relative, 1e-4
absolute). The absolute term is the bound: with visits ``v`` below 52,
``log(v + 2)`` lies under 4, where 4 ulps are 9.5e-7, and a reward of
40 / log(1.5) times that is 9.4e-5 off; the relative error of the factor
itself grows with ``v`` (about 1e-5 at ``v`` = 10), so no relative
tolerance alone holds. ``test_torch_generic_savanna_full.py`` prints the
gaps it reads under ``pytest -s``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
    AIntelopeSavanna as JEnv,
)
from ai_safety_gridworlds_tpu.ma import safety_game_ma as jma
from ai_safety_gridworlds_tpu.mo import map_randomization as jmr

from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
    AIntelopeSavanna as TEnv,
    SavannaState,
)
from ai_safety_gridworlds_torch.mo import map_randomization as tmr

from test_torch_generic_island_ma import (
    B,
    assert_close,
    assert_states,
    check_observe,
    check_rollout,
    check_teacher_forced,
    np_,
    to_port,
)
from torch_threads import one_torch_thread  # noqa: F401

N_TF = 30
N_ROLL = 60
GOLD_TOL = dict(rtol=1e-5, atol=1e-4)
SUSTAIN = {"sustainability_challenge": True}
FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
RICH_KW = dict(
    level=13, amount_agents=2, amount_predators=2, amount_drink_holes=2,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_water_tiles=2,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
AVAILS = ("drink_avail", "food_avail", "small_drink_avail",
          "small_food_avail")
CURTAINS = ("drink_curtain", "food_curtain", "small_drink_curtain",
            "small_food_curtain")


def approx_of(tenv):
    """How each savanna field is held where not exactly (the module
    docstring): the regrown availabilities, and the gold and silver
    dimensions of the rewards."""
    out = {}
    if tenv.cfg["sustainability_challenge"]:
        out.update({k: "frac" for k in AVAILS})
    dims = [k for k, name in enumerate(tenv.reward_space.keys)
            if name in ("GOLD", "SILVER")]
    out["rewards"] = (dims, GOLD_TOL)
    return out


@functools.lru_cache(maxsize=None)
def jax_rollout(kw_items, n_steps=N_ROLL, seed=5):
    env = JEnv(**dict(kw_items))
    return jax.jit(lambda k: jma.ma_rollout(env, k, n_steps, B))(
        jax.random.PRNGKey(seed))


def busy(jenv, seed):
    """A busy batch of JAX states: each lane's reset (board, overlays),
    then distinct random non-wall positions, step counts, satiations
    around the thresholds, directions, visits, a few terminated agents and,
    under sustainability, fractional availabilities."""
    n = jenv.n_agents
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    js = jax.vmap(lambda k: jenv.initial_state(
        k, jenv.sample_reset_options(jax.random.fold_in(k, 1))))(keys)
    rng = np.random.default_rng(seed)
    wall = np.asarray(js.wall)
    pos = np.stack([
        np.argwhere(~wall[b])[rng.choice((~wall[b]).sum(), n, replace=False)]
        for b in range(B)]).astype(np.int32)
    reasons = np.where(rng.random((B, n)) < 0.1, 3, -1).astype(np.int32)
    out = js.replace(
        t=jnp.asarray(rng.integers(0, 900, B), jnp.int32),
        pos=jnp.asarray(pos),
        termination_reasons=jnp.asarray(reasons),
        step_types=jnp.asarray(np.where(reasons >= 0, 2, 1), jnp.int32),
        action_direction=jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32),
        observation_direction=jnp.asarray(rng.integers(0, 4, (B, n)),
                                          jnp.int32),
        step_count=jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32),
        drink_satiation=jnp.asarray(
            rng.integers(-22, 6, (B, n)) * 0.5, jnp.float32),
        food_satiation=jnp.asarray(
            rng.integers(-22, 6, (B, n)) * 0.5, jnp.float32),
        visits=jnp.asarray(rng.integers(0, 9, (B, n, 7)), jnp.int32),
        safety=jnp.asarray(rng.integers(0, 9, (B, n)), jnp.int32),
        safety2=jnp.asarray(rng.integers(0, 9, (B, n)), jnp.int32),
    )
    if jenv.cfg["sustainability_challenge"]:
        out = out.replace(**{
            k: jnp.asarray(rng.uniform(0, 12, B), jnp.float32)
            for k in AVAILS})
    return out


def check_metrics(jenv, tenv, js, ts):
    """Each lane's JAX metrics dict against the port's values on the rows
    the lane shows (``metrics_shown``)."""
    tm, shown = tenv.metrics(ts), tenv.metrics_shown(ts)
    assert list(tm) == tenv.metrics_keys == jenv.metrics_keys
    for b in range(B):
        jm = jenv.metrics(jax.tree_util.tree_map(lambda x: x[b], js))
        assert sorted(jm) == sorted(k for k in tm if shown[k][b]), b
        for k, v in jm.items():
            assert np_(v) == tm[k][b].numpy(), (b, k)
            assert np_(v).dtype == tm[k].numpy().dtype, (b, k)


# ----------------------------------------------------------------- reset


@pytest.mark.parametrize("h,w", [(13, 13), (45, 45)])
def test_shuffle_interior_device_equals_jax(h, w):
    rng = np.random.default_rng(h)
    boards = rng.integers(32, 90, (B, h, w)).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(h), B)
    want = jax.jit(jax.vmap(jmr.shuffle_interior_device))(boards, keys)
    got = tmr.shuffle_interior_device(
        torch.from_numpy(boards), torch.from_numpy(np_(keys)))
    assert_close(want, got, None, "boards")
    # A shared board shuffled per lane.
    want = jax.vmap(jmr.shuffle_interior_device, (None, 0))(
        jnp.asarray(boards[0]), keys)
    got = tmr.shuffle_interior_device(
        torch.from_numpy(boards[0]), torch.from_numpy(np_(keys)))
    assert_close(want, got, None, "shared board")


RESET_CASES = [
    {},
    {"amount_food_patches": 5},  # a top-up on gap cells
    {"amount_food_patches": 200},  # beyond the free cells
    {"amount_food_patches": 6, "map_randomization_frequency": 0},
    # Picks on water, predator, gold and silver cells: overlays.
    dict(FULL, amount_drink_holes=5, amount_food_patches=200),
    RICH_KW,
    SUSTAIN,
]


@pytest.mark.parametrize("kw", RESET_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items())[:60] or "default")
def test_reset_options_and_initial_state_equal_jax(kw):
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jopts = jax.vmap(jenv.sample_reset_options)(keys)
    topts = tenv.sample_reset_options(torch.from_numpy(np_(keys)))
    assert sorted(jopts) == sorted(topts)
    for k in jopts:
        assert_close(jopts[k], topts[k], None, k)
    if kw.get("amount_predators"):
        assert topts["overlay_food_curtain"].any()
        assert topts["overlay_drink_curtain"].any()
    js = jax.vmap(jenv.initial_state)(keys, jopts)
    ts = tenv.initial_state(torch.from_numpy(np_(keys)), topts)
    assert_states(js, ts, {}, msg="initial_state")
    # Without options: the art's own board.
    js = jax.vmap(jenv.initial_state)(keys)
    ts = tenv.initial_state(torch.from_numpy(np_(keys)))
    assert_states(js, ts, {}, msg="initial_state without options")


# ------------------------------------------------------------------ steps


def inject_curtains(tenv, h, w):
    """Random ``inj_*`` curtains for the enabled resources and predators."""
    names = ["inj_predator_curtain"] if tenv._has_predators else []
    for ck, has in zip(CURTAINS, (tenv._has_drink, tenv._has_food,
                                  tenv._has_small_drink,
                                  tenv._has_small_food)):
        if has:
            names.append("inj_" + ck)

    def inject(rng):
        return {k: rng.random((B, h, w)) < 0.1 for k in names}

    return inject


STEP_CASES = [
    ("default", {}, False),
    ("sustain", SUSTAIN, False),
    ("sustain-predators-injected", dict(SUSTAIN, amount_predators=3),
     True),
    ("sustain-small", dict(SUSTAIN, amount_small_food_patches=2,
                           amount_drink_holes=1, penalise_oversatiation=True,
                           use_satiation_proportional_reward=True), False),
]


@pytest.mark.parametrize("kw,inject", [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_teacher_forced_steps_equal_jax(kw, inject):
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    check_teacher_forced(
        jenv, tenv, busy(jenv, 4), SavannaState, approx_of(tenv), N_TF,
        seed=6, inject=inject_curtains(tenv, tenv.h, tenv.w) if inject
        else None)


ROLL_CASES = [
    ("default", {"max_iterations": 40}),
    ("sustain", dict(SUSTAIN, max_iterations=40)),
    ("topup200", {"amount_food_patches": 200, "max_iterations": 40}),
]


@pytest.mark.parametrize("kw", [c[1] for c in ROLL_CASES],
                         ids=[c[0] for c in ROLL_CASES])
def test_ma_rollout_equals_jitted_jax(kw):
    """B = 32 lanes, 60 steps from one key; max_iterations=40 ends every
    lane's first episode at step 40, so the rollout crosses the reset
    branch's shuffle and top-up draws."""
    tenv = TEnv(**kw)
    tstats, _ = check_rollout(jax_rollout(tuple(sorted(kw.items()))), tenv,
                              N_ROLL, 5, approx_of(tenv))
    assert int(tstats["episodes"]) == B


def test_observe_and_metrics_equal_jax():
    for kw in ({}, SUSTAIN, {"amount_food_patches": 200}):
        jenv, tenv = JEnv(**kw), TEnv(**kw)
        js = busy(jenv, 8)
        ts = to_port(js, SavannaState)
        check_observe(jenv, tenv, js, ts, str(kw))
        check_metrics(jenv, tenv, js, ts)


def test_constructor_matches_jax():
    for kw in ({}, SUSTAIN, FULL, RICH_KW, {"map_width": 20,
                                           "map_height": 9}):
        j, t = JEnv(**kw), TEnv(**kw)
        for name in ("n_agents", "agent_chars", "metrics_keys",
                     "reference_init_metrics_order", "continuous_action_ranges",
                     "agent_observation_radii", "action_min", "action_max",
                     "what_lies_outside", "_reset_topup", "h", "w"):
            assert getattr(j, name) == getattr(t, name), name
        assert j.agent_reward_keys() == t.agent_reward_keys()
        assert j.reward_space.keys == t.reward_space.keys
        for name in ("_base_board", "_value_lut", "_rgb_lut"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name),
                                          err_msg=name)


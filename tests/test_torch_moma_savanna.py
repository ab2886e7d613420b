"""The multi-agent shell over aintelope_savanna against the JAX package's,
and the port's host mirror, on the CPU.

* The shell (the harness of ``test_torch_moma_shell.py``): the default
  savanna, two agents with predators, with ``sustainability_challenge``,
  and death by homeostasis; exact (the mirror's floats are float64 in both
  packages).
* The port's ``host_substep`` against JAX's, sub-step by sub-step from the
  same state and equal Generators: every state field, the reward deltas,
  the float64 shadows and the Generator's state exactly equal.
* The port's host mirror against the port's own chain with the mirror's
  draws injected (``inj_*``: the predators' curtain after the walk, the
  resource curtains after the drapes), the port's form of
  ``tests/test_savanna_device_parity.py`` with its dyadic flags: every
  integer and boolean field exact, satiations and availabilities within
  1e-6, rewards within 1e-5 relative (the chain's float32 logarithms of the
  gold and silver score against the mirror's float64 ``math.log``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core.actions import Directions
from ai_safety_gridworlds_tpu.envs import aintelope_savanna as jsav
from ai_safety_gridworlds_tpu.envs import island_navigation_ex_ma as jisl
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.core.actions import (
    DIR_TO_ACTION_MO,
    REL_MOVE_DIR,
)
from ai_safety_gridworlds_torch.envs import aintelope_savanna as tsav
from ai_safety_gridworlds_torch.helpers.safety_env import fetch_lane
from test_torch_moma_shell import (  # noqa: F401
    check_moma_against_jax,
    fresh_statics,
)

PREDATORS = dict(amount_agents=2, amount_predators=3, amount_drink_holes=2,
                 max_iterations=30)
SUSTAIN = dict(amount_agents=2, amount_drink_holes=2,
               sustainability_challenge=True, max_iterations=30)
DEATH = dict(amount_agents=2, amount_drink_holes=1, thirst_hunger_death=True,
             penalise_oversatiation=True, DRINK_DEFICIENCY_LIMIT=-4,
             FOOD_DEFICIENCY_LIMIT=-4, max_iterations=40)
DYADIC = dict(DRINK_DEFICIENCY_RATE=-0.25, FOOD_DEFICIENCY_RATE=-0.25,
              DRINK_EXTRACTION_RATE=1, FOOD_EXTRACTION_RATE=1,
              SMALL_DRINK_EXTRACTION_RATE=0.5,
              SMALL_FOOD_EXTRACTION_RATE=0.5)
FLOAT_FIELDS = {"drink_satiation", "food_satiation", "drink_avail",
                "food_avail", "small_drink_avail", "small_food_avail"}


@pytest.mark.parametrize("kw,max_steps", [
    ({"max_iterations": 25}, 25),
    (PREDATORS, 30),
    (SUSTAIN, 30),
    (DEATH, 40),
], ids=["default", "predators", "sustain", "death"])
def test_savanna_shell_equals_jax(kw, max_steps):
    jenv, tenv, exempt = check_moma_against_jax(
        "aintelope_savanna", kw, max_steps=max_steps)
    assert exempt == 0
    assert tenv.get_overall_performance() is not None
    if kw is DEATH:
        # An agent died of thirst or hunger in the last episode.
        dims = tenv.enabled_agents_reward_dimensions
        assert any(v[dims[a].index("THIRST_HUNGER_DEATH")] < 0
                   for a, v in tenv.get_last_performance().items())


def test_relative_direction_tables_equal_jax():
    np.testing.assert_array_equal(REL_MOVE_DIR, jisl._REL_DIR)
    np.testing.assert_array_equal(DIR_TO_ACTION_MO, jisl._DIR_TO_ACTION)
    assert int(Directions.UP) == int(tsav.Directions.UP)


def test_board_to_state_fields_equals_jax():
    kw = dict(amount_agents=3, amount_predators=2, amount_water_tiles=2,
              amount_gold_deposits=1, amount_small_food_patches=1)
    jenv, tenv = jsav.AIntelopeSavanna(**kw), tsav.AIntelopeSavanna(**kw)
    board = jenv._base_board.copy()
    board[1, 1] = ord(" ")  # agent '0' absent: it starts at (1, 1)
    jf, jpos = jenv._board_to_state_fields(board)
    tf, tpos = tenv._board_to_state_fields(board)
    np.testing.assert_array_equal(tpos, jpos)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def _jax_episode(env, rng, key):
    options = {k: jnp.asarray(v) for k, v in
               env.host_reset_options_with_generator(rng).items()}
    state = env.initial_state(key, options)
    return env.host_reset_sweep(state, rng)


def _port_episode(env, rng, key):
    options = {k: torch.as_tensor(np.asarray(v))[None] for k, v in
               env.host_reset_options_with_generator(rng).items()}
    state = env.initial_state(key[None], options)
    return env.host_reset_sweep(state, rng)


def _assert_lane(jstate, tstate, msg):
    lane = fetch_lane({f.name: getattr(tstate, f.name)
                       for f in dataclasses.fields(tstate) if f.name != "key"})
    for name, value in lane.items():
        j = np.asarray(getattr(jstate, name))
        assert j.dtype == value.dtype, (msg, name, j.dtype, value.dtype)
        np.testing.assert_array_equal(value, j, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("kw", [
    dict(PREDATORS, amount_gold_deposits=2, amount_silver_deposits=2,
         amount_water_tiles=2, PREDATOR_MOVEMENT_PROBABILITY=0.75),
    dict(SUSTAIN, amount_small_food_patches=1, penalise_oversatiation=True,
         use_satiation_proportional_reward=True),
], ids=["zoo", "sustain"])
def test_host_substep_equals_jax_substep_by_substep(kw):
    jenv, tenv = jsav.AIntelopeSavanna(**kw), tsav.AIntelopeSavanna(**kw)
    jrng, trng = np.random.default_rng(21), np.random.default_rng(21)
    actions = np.random.default_rng(22)
    n = tenv.n_agents
    jstate = _jax_episode(jenv, jrng, jax.random.PRNGKey(0))
    tstate = _port_episode(tenv, trng, threefry.PRNGKey(0))
    _assert_lane(jstate, tstate, "reset")
    substeps = 0
    for t in range(45):
        reasons = np.asarray(jstate.termination_reasons)
        acting = [j for j in range(n) if reasons[j] == -1]
        if not acting or int(jstate.t) >= jenv.max_iterations:
            jstate = _jax_episode(jenv, jrng, jax.random.PRNGKey(t))
            tstate = _port_episode(tenv, trng, threefry.PRNGKey(t))
            _assert_lane(jstate, tstate, f"reset {t}")
            continue
        order = jenv.host_agent_order(jrng, acting)
        np.testing.assert_array_equal(tenv.host_agent_order(trng, acting),
                                      order)
        overrides = {
            "action_direction_override": actions.integers(
                -1, 5, n).astype(np.int32),
            "observation_direction_override": actions.integers(
                -1, 5, n).astype(np.int32),
        }
        for slot in range(len(acting)):
            i, a = int(order[slot]), int(actions.integers(0, 10))
            jstate, jd = jenv.host_substep(jstate, i, a, jrng, overrides)
            tstate, td = tenv.host_substep(tstate, i, a, trng, overrides)
            msg = f"step {t} slot {slot} agent {i} action {a}"
            _assert_lane(jstate, tstate, msg)
            assert td.dtype == np.float32
            np.testing.assert_array_equal(td, jd, err_msg=msg)
            assert trng.bit_generator.state == jrng.bit_generator.state, msg
            assert tenv._host_avail == jenv._host_avail, msg
            for k in ("drink", "food"):
                np.testing.assert_array_equal(tenv._host_sat[k],
                                              jenv._host_sat[k], err_msg=msg)
            substeps += 1
    assert substeps > 40


@pytest.mark.parametrize("kw,seed", [
    (dict(amount_agents=2, amount_drink_holes=2, amount_gold_deposits=1,
          amount_silver_deposits=1, amount_water_tiles=2), 5),
    (dict(amount_agents=2, amount_predators=3, amount_water_tiles=0,
          PREDATOR_MOVEMENT_PROBABILITY=0.75), 9),
    (dict(amount_agents=2, amount_drink_holes=2,
          sustainability_challenge=True, DRINK_REGROWTH_EXPONENT=1.0), 11),
    (dict(amount_agents=2, amount_drink_holes=1, thirst_hunger_death=True,
          penalise_oversatiation=True, DRINK_DEFICIENCY_LIMIT=-4,
          FOOD_DEFICIENCY_LIMIT=-4), 13),
], ids=["default", "predators", "sustain", "death"])
def test_host_mirror_equals_the_chain_with_its_draws(kw, seed):
    env = tsav.AIntelopeSavanna(**kw, **DYADIC)
    rng = np.random.default_rng(seed)
    actions = np.random.RandomState(seed + 1)
    n = env.n_agents

    def fresh(ep):
        return _port_episode(env, rng, threefry.PRNGKey(seed * 1000 + ep))

    episode = 0
    host = dev = fresh(episode)
    validated = 0
    for t in range(80):
        lane = fetch_lane({"t": host.t,
                           "reasons": host.termination_reasons})
        if (lane["reasons"] != -1).all() or int(lane["t"]) >= \
                env.max_iterations:
            episode += 1
            host = dev = fresh(episode)
            continue
        acting = [j for j in range(n) if lane["reasons"][j] == -1]
        order = env.host_agent_order(rng, acting)
        acts = {j: int(actions.randint(0, 5)) for j in acting}
        for slot in range(n):
            i = int(order[slot])
            a = acts.get(i, -1)
            if a < 0:
                continue
            host, dh = env.host_substep(host, i, a, rng)
            inj = {f"inj_{c}": getattr(host, c) for c in (
                "predator_curtain", "drink_curtain", "food_curtain",
                "small_drink_curtain", "small_food_curtain")}
            dev, dd = env.apply_substep(
                dev, torch.tensor([i], dtype=torch.int32),
                torch.tensor([a], dtype=torch.int32), inj, slot)
            msg = f"step {t} slot {slot} agent {i}"
            for f in dataclasses.fields(host):
                if f.name == "key":
                    continue
                hv = getattr(host, f.name).numpy()
                dv = getattr(dev, f.name).numpy()
                if f.name in FLOAT_FIELDS:
                    np.testing.assert_allclose(dv, hv, rtol=1e-6, atol=1e-6,
                                               err_msg=f"{msg} {f.name}")
                else:
                    np.testing.assert_array_equal(dv, hv,
                                                  err_msg=f"{msg} {f.name}")
            np.testing.assert_allclose(dd[0].numpy().astype(np.float64),
                                       dh.astype(np.float64), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{msg} rewards")
            validated += 1
    assert validated > 40

"""The savanna kernel's PRF stream in the generic aintelope_savanna chain on
the CPU.

``FusedSavanna.lane_prf_ctx`` equals the JAX package's on the same packed
state (a busy one, draw counters across the uint32 wrap). Then, in the
manner of ``tests/test_fused_savanna.py``'s stream equivalence: the port's
plain fused step (``FusedSavanna._step``, the plain version of K8) with
its agent order and actions captured, replayed through the generic
sub-steps (``engine_substep`` via ``apply_substep``) on the lanes of the
typed ``unpack_lane``, each sub-step given only the lane's PRF context,
so that the generic chain draws the predator walk and the drapes' picks
from the kernel's own words; on the default configuration, under
sustainability and with predators and water, B = 8, 10 steps.

Tolerance. Every integer and boolean field (positions, directions, step
counts, visits, safety, the predator curtain and, under sustainability,
the resource curtains) and the step's rewards are exact on the lanes that
did not reset in the step; the satiations are exact; under sustainability
the plain step regrows through ``exp(e * log(x + 1))`` against the
chain's ``torch.pow``: the availabilities agree within 1e-4 (the JAX
package's bound for this comparison), and a lane whose regrown value came
within 1e-5 of an integer (the plain step's ``regrow_gap``) is exempt from
that step on and counted (at most one lane here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
    AIntelopeSavanna as JEnv,
)
from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna as JF

from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
    AIntelopeSavanna as TEnv,
    SavannaState,
)
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna as TF

from test_torch_generic_savanna import FULL, SUSTAIN

B = 8
STEPS = 10
GAP = 1e-5
FIELDS = [f.name for f in dataclasses.fields(SavannaState)]
EXACT = ("t", "pos", "step_types", "termination_reasons",
         "action_direction", "observation_direction", "step_count",
         "predator_curtain", "visits", "safety", "safety2",
         "drink_satiation", "food_satiation")
CURTAINS = ("drink_curtain", "food_curtain", "small_drink_curtain",
            "small_food_curtain")
AVAILS = ("drink_avail", "food_avail", "small_drink_avail",
          "small_food_avail")
PREDATORS = dict(amount_predators=3, amount_water_tiles=3)


def test_lane_prf_ctx_equals_jax():
    for kw in ({}, dict(FULL, **SUSTAIN)):
        tf, jf = TF(TEnv(**kw)), JF(JEnv(**kw))
        tS = interop.busy_savanna_state(tf, 3, 16, "cpu")
        jf.init_packed(seed=3, batch=16)
        assert jf.n_sites == tf.n_sites
        jS = {k: jnp.asarray(v)
              for k, v in interop.state_to_numpy(tS).items()}
        assert int(tS["draw_ctr"].to(torch.int64).max()) * tf.n_sites >= 2**32
        for lane in (0, 5, 15):
            for slot in range(tf.n):
                got = tf.lane_prf_ctx(tS, lane, slot)
                want = jf.lane_prf_ctx(jS, lane, slot)
                assert sorted(got) == sorted(want)
                for k, v in want.items():
                    assert got[k].shape == (1,) and got[k].dtype == torch.int64
                    assert int(got[k]) == int(np.asarray(v)), (lane, slot, k)


def _cat(states):
    return SavannaState(**{
        f: torch.cat([getattr(s, f) for s in states]) for f in FIELDS})


@pytest.mark.parametrize("kw", [{}, SUSTAIN, PREDATORS],
                         ids=["default", "sustain", "predators"])
def test_generic_substeps_under_prf_equal_fused_plain_step(kw):
    env = TEnv(**kw)
    fused = TF(env)
    S = fused.init_packed(seed=3, batch=B, device="cpu")
    n, D = fused.n, fused.D
    floats = AVAILS if fused.sustain else ()
    exact = EXACT + (CURTAINS if fused.sustain else ())
    exempt = torch.zeros(B, dtype=torch.bool)
    checked = 0
    drawn = set()  # the boards the PRF words moved
    for step in range(STEPS):
        state = _cat([fused.unpack_lane(S, b) for b in range(B)])
        before = state
        S2, dbg = fused._step(S, collect_draws=True)
        order, actions = dbg["order"], dbg["actions"]
        total = env.zero_rewards(B, "cpu")
        for slot in range(n):
            i = order[slot].to(torch.int32)
            a = actions.gather(0, i.long()[None])[0]
            ctx = [fused.lane_prf_ctx(S, b, slot) for b in range(B)]
            opts = {k: torch.cat([c[k] for c in ctx]) for k in ctx[0]}
            state, delta = env.apply_substep(state, i, a, opts, slot)
            total = total + delta
        state, _ = env.finalize_step(state, env.zero_rewards(B, "cpu"))
        exempt |= dbg["regrow_gap"][0] <= GAP
        live = ~dbg["over"][0] & ~exempt
        want = _cat([fused.unpack_lane(S2, b) for b in range(B)])
        for f in exact:
            assert torch.equal(getattr(state, f)[live],
                               getattr(want, f)[live]), (step, f)
        for f in floats:
            assert torch.allclose(getattr(state, f)[live],
                                  getattr(want, f)[live], rtol=0,
                                  atol=1e-4), (step, f)
        fused_rewards = dbg["rewards"].t().reshape(B, n, D)
        assert torch.equal(total[live], fused_rewards[live]), step
        checked += int(live.sum())
        drawn |= {f for f in ("predator_curtain",) + CURTAINS
                  if not torch.equal(getattr(state, f)[live],
                                     getattr(before, f)[live])}
        S = S2
    assert int(exempt.sum()) <= 1
    assert checked >= (STEPS - 2) * B
    if env._has_predators:
        assert "predator_curtain" in drawn
    if fused.sustain:
        assert "food_curtain" in drawn

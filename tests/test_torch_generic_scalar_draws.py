"""The generic chains of the scalar envs with draws against the JAX package
on the CPU: the reset draws of absent_supervisor (``bernoulli``),
distributional_shift (``randint``), safe_interruptibility and its MO
variant (``uniform``) and friend_foe (its bandit and box, and the policy
estimates carried across an auto-reset), and the per-step draws of
whisky_gold's human-player hijack and tomato_watering's drying.

The harness and the tolerances are ``test_torch_generic_scalar.py``'s:
everything exact but friend_foe's policies (4 ulps, near-tie auto-resets
exempt) and tomato's rewards and returns (1e-5 relative). The reset branch
of ``episode_step`` draws on every lane, so each env's reset draws consume
the key exactly as JAX's, on lanes that do not reset too.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_generic_scalar import (
    _ids,
    check_reset_and_step,
    check_rollout,
    envs,
)

from ai_safety_gridworlds_torch.core import base as tbase
from torch_threads import one_torch_thread  # noqa: F401

CASES = [
    ("absent_supervisor", {}),
    ("absent_supervisor", {"supervisor": True}),
    ("distributional_shift", {}),
    ("distributional_shift", {"is_testing": True}),
    ("distributional_shift", {"is_testing": True, "level_choice": 2}),
    ("safe_interruptibility", {}),
    ("safe_interruptibility", {"level": 0, "interruption_probability": 1.0}),
    ("safe_interruptibility", {"level": 2, "noops": True,
                               "interruption_probability": 0.0}),
    ("safe_interruptibility_ex", {}),
    ("whisky_gold", {}),
    ("whisky_gold", {"human_player": True}),
    ("tomato_watering", {}),
    ("tomato_crmdp", {}),
    ("friend_foe", {}),
    ("friend_foe", {"bandit_type": "friend"}),
    ("friend_foe", {"bandit_type": "adversary", "extra_step": True}),
]
# The configurations chip_smoke.py runs, and one each of the other draws.
ROLLOUTS = [CASES[i] for i in (0, 2, 3, 5, 8, 9, 10, 11, 12, 13, 15)]


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_reset_step_observe_equal_jax(name, kw):
    check_reset_and_step(name, kw)


@pytest.mark.parametrize("name,kw", ROLLOUTS, ids=_ids(ROLLOUTS))
def test_rollout_equals_jitted_jax(name, kw):
    check_rollout(name, kw)


@pytest.mark.parametrize("name,kw,field", [
    ("absent_supervisor", {}, "supervisor"),
    ("distributional_shift", {"is_testing": True}, "level"),
    ("safe_interruptibility", {}, "should_interrupt"),
    ("friend_foe", {}, "bandit_type"),
    ("tomato_watering", {}, "reset_dry_draws"),
], ids=["supervisor", "level", "interrupt", "bandit", "dry"])
def test_reset_options_equal_jax_and_vary(name, kw, field):
    """``sample_reset_options`` against ``jax.vmap`` of JAX's on 256 keys,
    and the draws take more than one value."""
    jenv, tenv = envs(name, kw)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(2), 256))
    jopt = jax.vmap(jenv.sample_reset_options)(keys)
    topt = tenv.sample_reset_options(torch.from_numpy(keys.astype(np.int64)))
    assert sorted(jopt) == sorted(topt)
    for k in jopt:
        got = topt[k].numpy()
        assert got.dtype == np.asarray(jopt[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(jopt[k]), got, err_msg=k)
    assert len(np.unique(topt[field].numpy())) > 1


def test_friend_foe_carries_its_policies_across_resets():
    # After a rollout the friend bandit's estimates moved off 0.5, and each
    # lane's level is the argmax of the policy it carried.
    _, tenv = envs("friend_foe", {"bandit_type": "friend"})
    eps, _ = tbase.rollout(tenv, 1, 120, 16, device="cpu")
    pol = eps.env_state.policies[:, 0]
    assert bool((pol != 0.5).any())
    assert torch.allclose(pol.sum(dim=1), torch.ones(16))

"""The port's per-lane linear policies (``set_policies``) against the JAX
package's.

The same numpy W / b / eps go to both packages. The port's plain rollout
must then be bit-identical (tolerance 0) to JAX's product-form step called
eagerly (``FusedFiremaker(env, mxu_stencil=False).step_xla``): the logits
are an elementwise chain in one order, the argmax takes the first maximum
by strict ``>`` in both, and exploration compares the fractional part of
``u * A`` with eps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa as TEnv
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_base import FusedMaBase
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker as TF,
    fused_firemaker_rollout,
)
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa as JEnv
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker as JF
from torch_threads import one_torch_thread  # noqa: F401


def _pair(**kw):
    return TF(TEnv(**kw)), JF(JEnv(**kw), mxu_stencil=False)


def _policy(tf, B, seed, shared=False):
    rng = np.random.default_rng(seed)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    lanes = () if shared else (B,)
    W = rng.normal(size=lanes + (A, F)).astype(np.float32)
    b = rng.normal(size=lanes + (A,)).astype(np.float32)
    eps = np.float32(0.1) if shared else rng.uniform(0, 0.3, B).astype(
        np.float32
    )
    return W, b, eps


def _assert_states_equal(tS, jS, fields, msg=""):
    for k in fields:
        np.testing.assert_array_equal(
            tS[k].numpy(), np.asarray(jS[k]), err_msg=f"{msg} field {k}"
        )


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize(
    "kw", [{}, {"action_direction_mode": 1, "observation_direction_mode": 1,
                "max_iterations": 24}],
    ids=["default", "dirs_reset"],
)
def test_policy_rollout_bit_identical_to_jax_eager(kw, shared):
    tf, jf = _pair(**kw)
    B = 32
    W, b, eps = _policy(tf, B, 3, shared)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS = tf.init_packed(5, B, "cpu")
    jS = jf.init_packed(seed=5, batch=B)
    acting = 0
    for step in range(20):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(
            td["actions"].numpy(), np.asarray(jd["actions"]),
            err_msg=f"step {step}",
        )
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
        acting += int((td["actions"] >= 0).sum())
    assert acting > 0
    # The policy changed what happened: the uniform rollout differs.
    tf.set_policies(None, None)
    tU = tf.rollout(tf.init_packed(5, B, "cpu"), 20)
    assert not torch.equal(tU["pos"], tS["pos"])


def test_policy_rollout_from_busy_state_and_cpu_wrapper():
    """From a mid-episode state (agents off their start cells, busy
    counters), and through ``rollout``: on the CPU the kernel's wrapper
    runs the plain loop, launches nothing and reads the policy."""
    tf, jf = _pair()
    B = 24
    W, b, eps = _policy(tf, B, 8)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    S0 = interop.busy_firemaker_state(tf, 4, B, "cpu")
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(S0).items()}
    before = fused_firemaker_rollout.launches
    tS = tf.rollout(S0, 12)
    assert fused_firemaker_rollout.launches == before
    for _ in range(12):
        jS = jf.step_xla(jS)
    _assert_states_equal(tS, jS, jf.STATE_FIELDS)


def test_policy_swap_and_removal_reach_the_next_rollout():
    tf, _ = _pair(max_iterations=30)
    B = 16
    S0 = tf.init_packed(2, B, "cpu")
    uniform = tf.rollout(S0, 10)
    tf.set_policies(*_policy(tf, B, 1))
    first = tf.rollout(S0, 10)
    tf.set_policies(*_policy(tf, B, 2))
    second = tf.rollout(S0, 10)
    tf.set_policies(None, None)
    removed = tf.rollout(S0, 10)
    assert not torch.equal(first["pos"], second["pos"])
    assert not torch.equal(first["pos"], uniform["pos"])
    for k in tf.STATE_FIELDS:
        assert torch.equal(removed[k], uniform[k]), k


@pytest.mark.parametrize("args", [
    (np.zeros((4, 6)), np.zeros(5)),         # W [A-1, F]
    (np.zeros((5, 5)), np.zeros(5)),         # W [A, F-1]
    (np.zeros((5, 6)), np.zeros(4)),         # b [A-1]
    (np.zeros((3, 5, 6)), np.zeros((2, 5))),  # lane dims disagree
    (np.zeros((3, 5, 6)), np.zeros(5), np.zeros(2)),
], ids=["w_actions", "w_features", "b_actions", "lanes_wb", "lanes_eps"])
def test_set_policies_shape_errors_match_jax(args):
    tf, jf = _pair()
    with pytest.raises(ValueError) as te:
        tf.set_policies(*args)
    with pytest.raises(ValueError) as je:
        jf.set_policies(*args)
    assert str(te.value) == str(je.value)


def test_policy_batch_must_match_and_kernels_without_features_raise():
    tf, _ = _pair()
    tf.set_policies(*_policy(tf, 8, 0))
    with pytest.raises(ValueError, match="policy batch 8 != packed batch 16"):
        tf.rollout(tf.init_packed(0, 16, "cpu"), 1)
    with pytest.raises(NotImplementedError):
        FusedMaBase().set_policies(np.zeros((5, 6)), np.zeros(5))

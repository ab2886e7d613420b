"""The port's PPO collection (MLP policy in the step, trajectory records,
bootstrap value) against the JAX package's.

Params come from the JAX package's ``ppo_fused.init_params`` and are carried
over with ``interop.params_from_numpy``; both packages run the product-form
step, JAX's called eagerly (``step_xla`` / ``_collect_step``).

Tolerances:

* Integer state, actions, rewards, dones and features are equal. The one
  exemption is a lane where some agent's site-0 uniform lies within 1e-6 of
  a cumulative softmax sum (the port reports that margin as ``cdf_gap``):
  there the float32 rounding of the two MLPs may flip the draw.
* ``logp`` and ``value`` agree within 1e-5: JAX leaves the MLP to its
  matrix products, the port accumulates in the kernel's fixed order, and
  the two differ in the last bits.
* ``boot`` agrees with ``ppo_fused.forward`` within 1e-4, as the JAX
  package's own test holds its kernel (``tests/test_fused_ppo.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa as TEnv
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker as TF,
    fused_firemaker_collect,
)
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa as JEnv
from ai_safety_gridworlds_tpu.learners import ppo_fused
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker as JF

GAP = 1e-6
INTS = ("action", "reward", "done", "feats")


def _setup(seed=0, hidden=16, **kw):
    tf, jf = TF(TEnv(**kw)), JF(JEnv(**kw), mxu_stencil=False)
    p_j = ppo_fused.init_params(
        jax.random.PRNGKey(seed), jf.POLICY_FEATURES, jf.amax - jf.amin + 1,
        hidden=hidden,
    )
    p_t = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in p_j.items()}, "cpu"
    )
    return tf, jf, p_j, p_t


def _jax_collect(jf, S, p_j):
    return jf._collect_step(S, {**jf._statics_jnp(), **p_j}, jf._consts_jnp())


@pytest.mark.parametrize(
    "kw", [{}, {"max_iterations": 8, "action_direction_mode": 2,
                "observation_direction_mode": 1}],
    ids=["default", "dirs_reset"],
)
def test_collect_step_from_shared_states_matches_jax_eager(kw):
    tf, jf, p_j, p_t = _setup(seed=1, **kw)
    B = 64
    S_t = interop.busy_firemaker_state(tf, 3, B, "cpu")
    S_np = interop.state_to_numpy(S_t)
    statics = tf._collect_statics(S_t, p_t)
    exempt_total = 0
    for step in range(10):
        S_t = interop.state_from_numpy(S_np, "cpu")
        S_j = {k: jnp.asarray(v) for k, v in S_np.items()}
        tS2, trec, tex = tf._collect_step(S_t, statics)
        jS2, jrec = _jax_collect(jf, S_j, p_j)
        exempt = (tex["pol"]["cdf_gap"] < GAP).any(dim=0).numpy()
        exempt_total += int(exempt.sum())
        keep = ~exempt
        for k in INTS:
            np.testing.assert_array_equal(
                trec[k].numpy()[:, keep], np.asarray(jrec[k])[:, keep],
                err_msg=f"step {step} {k}",
            )
        for k in jf.STATE_FIELDS:
            np.testing.assert_array_equal(
                tS2[k].numpy()[:, keep], np.asarray(jS2[k])[:, keep],
                err_msg=f"step {step} state {k}",
            )
        np.testing.assert_allclose(
            trec["value"].numpy(), np.asarray(jrec["value"]), rtol=0, atol=1e-5
        )
        np.testing.assert_allclose(
            trec["logp"].numpy()[:, keep], np.asarray(jrec["logp"])[:, keep],
            rtol=0, atol=1e-5,
        )
        # Teacher forcing: both continue from JAX's state.
        S_np = {k: np.asarray(v) for k, v in jS2.items()}
    assert exempt_total <= 2
    acts = trec["action"].numpy()
    assert ((acts >= tf.amin) | (acts == -1)).all() and (acts <= tf.amax).all()


def test_rollout_collect_matches_jax_eager_loop_and_forward():
    tf, jf, p_j, p_t = _setup(seed=2, max_iterations=12)
    B, T = 48, 8
    before = fused_firemaker_collect.launches
    tS, traj, boot = tf.rollout_collect(tf.init_packed(4, B, "cpu"), p_t, T)
    assert fused_firemaker_collect.launches == before  # the plain loop
    jS = jf.init_packed(seed=4, batch=B)
    recs = []
    for _ in range(T):
        jS, rec = _jax_collect(jf, jS, p_j)
        recs.append(rec)
    for name, rows, dtype in tf._traj_layout():
        assert traj[name].shape == (T, rows, B) and traj[name].dtype == dtype
        want = np.stack([np.asarray(r[name]) for r in recs])
        if name in INTS:
            np.testing.assert_array_equal(traj[name].numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(traj[name].numpy(), want, rtol=0,
                                       atol=1e-5, err_msg=name)
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(tS[k].numpy(), np.asarray(jS[k]), err_msg=k)
    # The bootstrap value is the learner-side forward on the final features.
    feats = tf.feats_of(tS)
    assert boot.shape == (tf.n, B)
    for j in range(tf.n):
        X = torch.cat(feats[j], dim=0).numpy().T
        _, v = ppo_fused.forward(p_j, jnp.asarray(X))
        np.testing.assert_allclose(boot[j].numpy(), np.asarray(v), atol=1e-4)
    assert np.abs(traj["reward"].numpy()).sum() > 0
    assert (traj["action"].numpy() == -1).any()  # crossed a reset


def test_valid_masks_reset_and_dead_steps():
    tf, _, _, p_t = _setup(seed=3, hidden=8, max_iterations=6)
    _, traj, _ = tf.rollout_collect(tf.init_packed(5, 16, "cpu"), p_t, 20)
    acts, dones = traj["action"].numpy(), traj["done"].numpy()
    assert (acts == -1).any() and dones.any()
    # A step after an all-done step is a reset emission (-1 everywhere).
    t_idx, b_idx = np.nonzero(dones.all(axis=1)[:-1])
    assert t_idx.size > 0
    assert (acts[t_idx + 1, :, b_idx] == -1).all()
    # logp and value are emitted for reset lanes too, and are finite.
    assert np.isfinite(traj["logp"].numpy()).all()
    assert np.isfinite(traj["value"].numpy()).all()


def test_rollout_collect_checks_its_inputs():
    tf, _, _, p_t = _setup()
    S = tf.init_packed(0, 8, "cpu")
    with pytest.raises(ValueError, match="missing MLP param 'mlp_b2'"):
        tf.rollout_collect(S, {k: v for k, v in p_t.items() if k != "mlp_b2"}, 2)
    _, traj, boot = tf.rollout_collect(S, p_t, 0)
    assert traj["feats"].shape == (0, tf.n * 6, 8) and boot.shape == (tf.n, 8)


def test_params_round_trip():
    _, _, p_j, p_t = _setup()
    back = interop.params_to_numpy(p_t)
    for k, v in p_j.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], np.asarray(v))

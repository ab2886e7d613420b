"""The port's island_navigation_ex_ma PPO collection, linear policies and
learning gate against the JAX package's.

Tolerances, as in ``tests/test_torch_collect.py``:

* Integer state, actions, rewards, dones and features are equal, except on
  a lane where some step's site-0 uniform lies within 1e-6 of a cumulative
  softmax sum (``cdf_gap``): there the float32 rounding of the two MLPs may
  flip the draw, and the lane's episode then diverges.
* ``logp``, ``value`` and ``boot`` agree within 1e-5: JAX leaves the MLP to
  its matrix products, the port accumulates in the kernel's fixed order.

The default configuration's rewards are integers, so the per-agent reward
sums are exact. The linear policy is exact: the logits are one elementwise
chain in both packages, compared against JAX's eager step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavigationExMa as TE,
)
from ai_safety_gridworlds_torch.learners import ppo_fused as tppo
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa as TF
from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa as JE,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa as JF
from torch_threads import one_torch_thread  # noqa: F401

GAP = 1e-6
INTS = ("feats", "action", "reward", "done")


@pytest.mark.parametrize("start", ["init", "busy"])
def test_rollout_collect_matches_jax_xla(start):
    kw = {"max_iterations": 24}
    tf, jf = TF(TE(**kw)), JF(JE(**kw))
    B, T_ = 96, 24
    p_j = jppo.init_params(
        jax.random.PRNGKey(1), jf.POLICY_FEATURES, jf.amax - jf.amin + 1,
        hidden=16,
    )
    # Larger policy weights than init's near-uniform ones, so that the
    # draws depend on the features.
    p_j = {**p_j, "mlp_w2": p_j["mlp_w2"] * 30.0}
    p_t = interop.params_from_numpy({k: np.asarray(v) for k, v in p_j.items()},
                                    "cpu")
    if start == "init":
        tS0 = tf.init_packed(4, B, "cpu")
    else:
        tS0 = interop.busy_island_ma_state(tf, 4, B, "cpu")
    S_np = interop.state_to_numpy(tS0)
    jf.init_packed(seed=4, batch=B)
    jS, jtraj, jboot = jf.rollout_collect(
        {k: jnp.asarray(v) for k, v in S_np.items()}, p_j, T_, backend="xla"
    )
    tS, traj, boot = tf.rollout_collect(tS0, p_t, T_)
    # The lanes whose draw lies near a CDF boundary at some step, from the
    # plain step loop (rollout_collect_plain runs the same loop).
    statics = tf._collect_statics(tS0, p_t)
    S, exempt = tS0, torch.zeros(B, dtype=torch.bool)
    for _ in range(T_):
        S, _, ex = tf._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < GAP).any(dim=0)
    for k in tf.STATE_FIELDS:
        assert torch.equal(S[k], tS[k]), k
    keep = ~exempt.numpy()
    assert exempt.sum() <= 2
    for nm, rows, dtype in tf._traj_layout():
        assert traj[nm].shape == (T_, rows, B) and traj[nm].dtype == dtype
        got, want = traj[nm].numpy()[..., keep], np.asarray(jtraj[nm])[..., keep]
        if nm in INTS:
            np.testing.assert_array_equal(got, want, err_msg=nm)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=nm)
    for k in jf.STATE_FIELDS:
        np.testing.assert_array_equal(tS[k].numpy()[:, keep],
                                      np.asarray(jS[k])[:, keep], err_msg=k)
    np.testing.assert_allclose(boot.numpy()[:, keep], np.asarray(jboot)[:, keep],
                               rtol=0, atol=1e-5)
    acts = traj["action"].numpy()
    assert (acts == -1).any() and (acts >= tf.amin).any()
    assert traj["done"].numpy().any()
    assert traj["feats"].shape[1] == tf.n * 10


def test_collection_sums_the_reward_dims():
    """Each record's reward is the agent's [D] reward rows summed in order
    (D = 8 on the default configuration)."""
    tf = TF(TE())
    assert tf.D == 8
    p = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jppo.init_params(
            jax.random.PRNGKey(0), 10, tf.amax - tf.amin + 1, hidden=8
        ).items()}, "cpu",
    )
    S = interop.busy_island_ma_state(tf, 6, 32, "cpu")
    statics = tf._collect_statics(S, p)
    for _ in range(8):
        S, rec, ex = tf._collect_step(S, statics)
        want = ex["rewards"].view(tf.n, tf.D, 32).sum(1)
        torch.testing.assert_close(rec["reward"], want, rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
def test_linear_policy_matches_jax_eager(shared):
    kw = {"max_iterations": 30}
    tf, jf = TF(TE(**kw)), JF(JE(**kw))
    B = 64
    rng = np.random.default_rng(3)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    lanes = () if shared else (B,)
    W = rng.normal(size=lanes + (A, F)).astype(np.float32)
    b = rng.normal(size=lanes + (A,)).astype(np.float32)
    eps = np.float32(0.1) if shared else rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS = interop.busy_island_ma_state(tf, 8, B, "cpu")
    jf.init_packed(seed=8, batch=B)
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    for step in range(25):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(td["actions"].numpy(),
                                      np.asarray(jd["actions"]),
                                      err_msg=f"step {step}")
        for k in jf.STATE_FIELDS:
            np.testing.assert_array_equal(tS[k].numpy(), np.asarray(jS[k]),
                                          err_msg=f"step {step} {k}")
    # The policy changed what happened: the uniform rollout differs.
    tf.set_policies(None, None)
    tU = tf.rollout(interop.busy_island_ma_state(tf, 8, B, "cpu"), 25)
    assert not torch.equal(tU["pos"], tS["pos"])


def test_fused_ppo_learns_island_ma():
    """Mirrors tests/test_ppo_learning.py::test_fused_ppo_learns_island_ma
    with the port's learner and the plain collection: 40 CPU-sized updates
    must lift the mean evaluated episode return by more than 30 to above
    -10, with more than 50 episodes evaluated before and after.
    ``chip_smoke.py`` runs the same gate through the collection kernel K7
    on the card. The port's parameter draws come from a
    ``torch.Generator``, not ``jax.random``, so the returns differ from the
    JAX test's."""
    fused = TF(TE())
    config = tppo.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = tppo.init_train_state(fused, 64, seed=3, config=config,
                                  device="cpu")
    train = tppo.make_train_step(fused, config, device="cpu")
    ev0 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    for _ in range(40):
        state, metrics = train(state)
    assert torch.isfinite(metrics["mean_reward"])
    ev1 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    print(f"island_navigation_ex_ma gate on the CPU: r0 {r0}, r1 {r1}")
    assert ev0["episodes"] > 50 and ev1["episodes"] > 50
    assert r1 - r0 > 30.0, (r0, r1)
    assert r1 > -10.0, r1

"""The port's aintelope_savanna PPO collection, linear policies and learning
gate against the JAX package's.

Tolerances, as in ``tests/test_torch_collect.py``:

* Integer state, actions, dones and features are equal, except on a lane
  where some step's site-0 uniform lies within 1e-6 of a cumulative softmax
  sum (``cdf_gap``): there the float32 rounding of the two MLPs may flip
  the draw, and the lane's episode then diverges.
* ``logp``, ``value`` and ``boot`` agree within 1e-5: JAX leaves the MLP to
  its matrix products, the port accumulates in the kernel's fixed order.
* Rewards are exact but for the gold and silver terms, which take ``log``:
  the per-agent sums over the reward dims agree within 1e-5 plus 1e-6 of
  their size, and so do the float state fields.

The linear policy is exact: the logits are one elementwise chain in both
packages, compared against JAX's eager step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
    AIntelopeSavanna as TE,
)
from ai_safety_gridworlds_torch.learners import ppo_fused as tppo
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna as TF
from ai_safety_gridworlds_tpu.envs.aintelope_savanna import (
    AIntelopeSavanna as JE,
)
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops.fused_savanna import FusedSavanna as JF
from torch_threads import one_torch_thread  # noqa: F401

GAP = 1e-6
INTS = ("feats", "action", "done")
# Level 0 with every feature its art holds (tests/test_torch_fused_savanna.py).
FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)


def _params(jf, seed, hidden=16):
    p_j = jppo.init_params(
        jax.random.PRNGKey(seed), jf.POLICY_FEATURES, jf.amax - jf.amin + 1,
        hidden=hidden,
    )
    # Larger policy weights than init's near-uniform ones, so that the draws
    # depend on the features.
    p_j = {**p_j, "mlp_w2": p_j["mlp_w2"] * 30.0}
    return p_j, interop.params_from_numpy(
        {k: np.asarray(v) for k, v in p_j.items()}, "cpu")


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("kw", [{}, FULL, dict(FULL, sustainability_challenge=True)],
                         ids=["default", "full", "full_sustain"])
def test_rollout_collect_matches_jax_xla(kw, start):
    kw = dict(kw, max_iterations=16)
    tf, jf = TF(TE(**kw)), JF(JE(**kw))
    B, T_ = 48, 20
    p_j, p_t = _params(jf, 1)
    tf.init_packed(4, B, "cpu")
    if start == "init":
        tS0 = tf.init_packed(4, B, "cpu")
    else:
        tS0 = interop.busy_savanna_state(tf, 4, B, "cpu")
    jf.init_packed(seed=4, batch=B)
    jS, jtraj, jboot = jf.rollout_collect(
        {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS0).items()},
        p_j, T_, backend="xla",
    )
    tS, traj, boot = tf.rollout_collect(tS0, p_t, T_)
    # The lanes whose draw lies near a CDF boundary, or whose regrowth near
    # an integer, at some step, from the plain step loop
    # (rollout_collect_plain runs the same loop).
    statics = tf._collect_statics(tS0, p_t)
    S, exempt = tS0, torch.zeros(B, dtype=torch.bool)
    for _ in range(T_):
        S, _, ex = tf._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < GAP).any(dim=0)
        exempt |= ex["regrow_gap"][0] < 1e-4
    for k in tf.STATE_FIELDS:
        assert torch.equal(S[k], tS[k]), k
    keep = ~exempt.numpy()
    assert exempt.sum() <= B // 8
    for nm, rows, dtype in tf._traj_layout():
        assert traj[nm].shape == (T_, rows, B) and traj[nm].dtype == dtype
        got, want = traj[nm].numpy()[..., keep], np.asarray(jtraj[nm])[..., keep]
        if nm in INTS:
            np.testing.assert_array_equal(got, want, err_msg=nm)
        else:
            rtol = 1e-6 if nm == "reward" else 0  # gold/silver log terms
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5,
                                       err_msg=nm)
    for k in jf.STATE_FIELDS:
        got, want = tS[k].numpy()[:, keep], np.asarray(jS[k])[:, keep]
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(boot.numpy()[:, keep], np.asarray(jboot)[:, keep],
                               rtol=0, atol=1e-5)
    acts = traj["action"].numpy()
    assert (acts == -1).any() and (acts >= tf.amin).any()
    assert traj["done"].numpy().any()
    assert traj["feats"].shape[1] == tf.n * 10


def test_collection_sums_the_reward_dims():
    """Each record's reward is the agent's [D] reward rows summed in order
    (D = 12 on FULL)."""
    tf = TF(TE(**FULL))
    assert tf.D == 12
    _, p = _params(JF(JE(**FULL)), 0, hidden=8)
    tf.init_packed(6, 32, "cpu")
    S = interop.busy_savanna_state(tf, 6, 32, "cpu")
    statics = tf._collect_statics(S, p)
    for _ in range(8):
        S, rec, ex = tf._collect_step(S, statics)
        r = ex["rewards"].view(tf.n, tf.D, 32)
        want = r[:, 0]
        for d in range(1, tf.D):
            want = want + r[:, d]
        torch.testing.assert_close(rec["reward"], want, rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
def test_linear_policy_matches_jax_eager(shared):
    kw = dict(FULL, max_iterations=30)
    tf, jf = TF(TE(**kw)), JF(JE(**kw))
    B = 48
    rng = np.random.default_rng(3)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    lanes = () if shared else (B,)
    W = rng.normal(size=lanes + (A, F)).astype(np.float32)
    b = rng.normal(size=lanes + (A,)).astype(np.float32)
    eps = np.float32(0.1) if shared else rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tf.init_packed(8, B, "cpu")
    tS = interop.busy_savanna_state(tf, 8, B, "cpu")
    jf.init_packed(seed=8, batch=B)
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    for step in range(12):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(td["actions"].numpy(),
                                      np.asarray(jd["actions"]),
                                      err_msg=f"step {step}")
        for k in jf.STATE_FIELDS:
            if k == "stats_rewards":
                np.testing.assert_allclose(tS[k].numpy(), np.asarray(jS[k]),
                                           rtol=1e-6, atol=1e-5)
            else:
                np.testing.assert_array_equal(tS[k].numpy(), np.asarray(jS[k]),
                                              err_msg=f"step {step} {k}")
    # The policy changed what happened: the uniform rollout differs.
    tf.set_policies(None, None)
    tU = tf.rollout(interop.busy_savanna_state(tf, 8, B, "cpu"), 12)
    assert not torch.equal(tU["pos"], tS["pos"])


def test_fused_ppo_learns_savanna():
    """Mirrors tests/test_ppo_learning.py::test_fused_ppo_learns_savanna
    with the port's learner and the plain collection: 60 CPU-sized updates
    must lift the mean evaluated episode return by more than 15 to above
    -15, with more than 50 episodes evaluated before and after.
    ``chip_smoke.py`` runs the same gate through the collection kernel K9
    on the card. The port's parameter draws come from a
    ``torch.Generator``, not ``jax.random``, so the returns differ from the
    JAX test's."""
    fused = TF(TE(max_iterations=50))
    config = tppo.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = tppo.init_train_state(fused, 64, seed=3, config=config,
                                  device="cpu")
    train = tppo.make_train_step(fused, config, device="cpu")
    ev0 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    for _ in range(60):
        state, metrics = train(state)
    assert torch.isfinite(metrics["mean_reward"])
    ev1 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    print(f"aintelope_savanna gate on the CPU: r0 {r0}, r1 {r1}")
    assert ev0["episodes"] > 50 and ev1["episodes"] > 50
    assert r1 - r0 > 15.0, (r0, r1)
    assert r1 > -15.0, r1

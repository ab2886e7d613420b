"""The port's fused-PPO learner (``learners/ppo_fused.py``) against NumPy
oracles and the JAX package's learner.

* GAE and the clipped-surrogate loss on a recorded trajectory against the
  loop-based NumPy oracles of ``tests/test_ppo_learning.py`` (copied here),
  with that file's tolerances.
* One ``_update_from_traj`` on a JAX-recorded firemaker trajectory against
  JAX's own update from the same params. The first minibatch's gradients
  agree within rtol 1e-4 (float32 sums in other orders). The params after
  the update agree within 1e-6 where the first gradient is well above its
  rounding, and within ``2 * lr`` per update everywhere: Adam's first steps
  scale every gradient to about ``lr``, so a near-zero component whose sign
  differs between the two float32 sums moves by up to ``lr`` either way.
* ``evaluate`` against a host replay of the emitted trajectory.
* The train step on the CPU, and CUDA entry points raising without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa as TEnv
from ai_safety_gridworlds_torch.learners import ppo_fused as tppo
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker as TF
from ai_safety_gridworlds_tpu.envs.firemaker_ex_ma import FiremakerExMa as JEnv
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops.fused_firemaker import FusedFiremaker as JF
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# NumPy oracles (from tests/test_ppo_learning.py): loop implementations of
# GAE and the PPO clipped-surrogate objective.
# ---------------------------------------------------------------------------


def np_gae(reward, value, cont, bootstrap, discount, lam):
    T = reward.shape[0]
    adv = np.zeros_like(reward)
    next_value, next_adv = bootstrap, np.zeros_like(bootstrap)
    for t in range(T - 1, -1, -1):
        delta = reward[t] + discount * cont[t] * next_value - value[t]
        adv[t] = delta + discount * lam * cont[t] * next_adv
        next_value, next_adv = value[t], adv[t]
    return adv, adv + value


def np_mlp_forward(params, X):
    w1 = np.asarray(params["mlp_w1"], np.float64)
    b1 = np.asarray(params["mlp_b1"], np.float64)[:, 0]
    w2 = np.asarray(params["mlp_w2"], np.float64)
    b2 = np.asarray(params["mlp_b2"], np.float64)[:, 0]
    h = np.maximum(X @ w1.T + b1, 0.0)
    out = h @ w2.T + b2
    return out[:, :-1], out[:, -1]


def np_ppo_loss(logits, value, action_idx, old_logp, valid, adv, ret, cfg):
    z = logits - logits.max(axis=1, keepdims=True)
    lse = np.log(np.exp(z).sum(axis=1))
    logp_all = z - lse[:, None]
    logp = logp_all[np.arange(len(action_idx)), action_idx]
    m = valid
    denom = max(m.sum(), 1.0)
    am = (adv * m).sum() / denom
    astd = np.sqrt((((adv - am) ** 2) * m).sum() / denom + 1e-8)
    advn = (adv - am) / astd
    ratio = np.exp(logp - old_logp)
    clipped = np.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    pol = -(np.minimum(ratio * advn, clipped * advn) * m).sum() / denom
    vl = (((value - ret) ** 2) * m).sum() / denom
    p = np.exp(logp_all)
    ent = ((-(p * logp_all).sum(axis=1)) * m).sum() / denom
    return {
        "loss": pol + cfg.value_coef * vl - cfg.entropy_coef * ent,
        "policy_loss": pol,
        "value_loss": vl,
        "entropy": ent,
    }


# ---------------------------------------------------------------------------


def _record_port(T=12, B=16, seed=3, hidden=16):
    tf = TF(TEnv(max_iterations=10))
    params = tppo.init_params(
        tf.POLICY_FEATURES, tf.amax - tf.amin + 1, hidden,
        torch.Generator().manual_seed(seed), "cpu",
    )
    _, traj, boot = tf.rollout_collect(
        tf.init_packed(seed + 1, B, "cpu"), params, T
    )
    return tf, params, traj, boot


def test_gae_packed_matches_numpy_on_recorded_trajectory():
    _, _, traj, boot = _record_port()
    config = tppo.FusedPPOConfig(discount=0.97, gae_lambda=0.9)
    cont = 1.0 - traj["done"].to(torch.float32)
    adv_t, ret_t = tppo._gae_packed(
        {"reward": traj["reward"], "value": traj["value"], "cont": cont},
        boot, config,
    )
    adv_n, ret_n = np_gae(
        traj["reward"].numpy().astype(np.float64),
        traj["value"].numpy().astype(np.float64),
        cont.numpy().astype(np.float64),
        boot.detach().numpy().astype(np.float64),
        config.discount, config.gae_lambda,
    )
    np.testing.assert_allclose(adv_t.numpy(), adv_n, atol=1e-4)
    np.testing.assert_allclose(ret_t.numpy(), ret_n, atol=1e-4)
    assert (cont == 0.0).any() and traj["reward"].abs().sum() > 0


def test_loss_packed_matches_numpy_on_recorded_trajectory():
    tf, params, traj, boot = _record_port()
    config = tppo.FusedPPOConfig()
    n, F = tf.n, tf.POLICY_FEATURES
    A, amin = tf.amax - tf.amin + 1, int(tf.amin)
    tr = {k: v.numpy() for k, v in traj.items()}
    cont = 1.0 - tr["done"].astype(np.float32)
    adv, ret = np_gae(tr["reward"], tr["value"], cont, boot.detach().numpy(),
                      config.discount, config.gae_lambda)
    valid = (tr["action"] >= 0).astype(np.float32)
    mb = {
        "feats": traj["feats"], "action": traj["action"], "logp": traj["logp"],
        "valid": torch.from_numpy(valid),
        "adv": torch.from_numpy(adv.astype(np.float32)),
        "ret": torch.from_numpy(ret.astype(np.float32)),
    }
    loss_t, metrics_t = tppo._loss_packed(params, mb, (n, F, A, amin), config)

    T, _, B = tr["action"].shape
    X = np.concatenate([
        tr["feats"][:, j * F : (j + 1) * F, :].transpose(0, 2, 1).reshape(T * B, F)
        for j in range(n)
    ], axis=0)
    logits, value = np_mlp_forward(interop.params_to_numpy(params),
                                   X.astype(np.float64))

    def flat(x):
        return np.concatenate([x[:, j, :].reshape(T * B) for j in range(n)])

    out_n = np_ppo_loss(
        logits, value, np.maximum(flat(tr["action"]) - amin, 0),
        flat(tr["logp"]).astype(np.float64), flat(valid).astype(np.float64),
        flat(adv), flat(ret), config,
    )
    np.testing.assert_allclose(float(loss_t.detach()), out_n["loss"], rtol=1e-5, atol=2e-4)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(metrics_t[k].detach()), out_n[k], rtol=1e-5,
                                   atol=2e-4, err_msg=k)
    assert (valid == 0).any()


def test_update_from_jax_trajectory_matches_jax_update():
    config = jppo.FusedPPOConfig(n_steps=10, n_epochs=2, n_minibatches=2,
                                 hidden=16)
    tconfig = tppo.FusedPPOConfig(**config._asdict())
    jf = JF(JEnv(max_iterations=8), mxu_stencil=False)
    dims = (jf.n, jf.POLICY_FEATURES, jf.amax - jf.amin + 1, int(jf.amin))
    p_j = jppo.init_params(jax.random.PRNGKey(5), jf.POLICY_FEATURES,
                           dims[2], hidden=16)
    _, traj_j, boot_j = jf.rollout_collect(
        jf.init_packed(seed=6, batch=32), p_j, config.n_steps, backend="xla"
    )
    traj_np = {k: np.asarray(v) for k, v in traj_j.items()}
    boot_np = np.asarray(boot_j)

    # JAX: the first minibatch's gradients, then the whole update.
    cont = 1.0 - traj_j["done"].astype(jnp.float32)
    adv, ret = jppo._gae_packed(
        {"reward": traj_j["reward"], "value": traj_j["value"], "cont": cont},
        boot_j, config,
    )
    valid = (traj_j["action"] >= 0).astype(jnp.float32)
    data = {"feats": traj_j["feats"], "action": traj_j["action"],
            "logp": traj_j["logp"], "valid": valid, "adv": adv, "ret": ret}
    mb0 = jax.tree.map(lambda x: x[..., :16], data)
    g_j = jax.grad(jppo._loss_packed, has_aux=True)(p_j, mb0, dims, config)[0]
    opt = jppo._optimizer(config)
    p_j2, _, m_j = jppo._update_from_traj(
        jf, traj_j, boot_j, p_j, opt.init(p_j), opt, dims, config
    )

    # The port, from the same params and trajectory.
    p_np = {k: np.asarray(v) for k, v in p_j.items()}
    p_t = {k: v.requires_grad_() for k, v in
           interop.params_from_numpy(p_np, "cpu").items()}
    traj_t = {k: torch.from_numpy(np.array(v)) for k, v in traj_np.items()}
    boot_t = torch.from_numpy(np.array(boot_np))
    mb0_t = tppo._minibatches(traj_t, boot_t, tconfig)[0]
    for k in mb0_t:
        np.testing.assert_allclose(mb0_t[k].numpy(), np.asarray(mb0[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    loss_t, _ = tppo._loss_packed(p_t, mb0_t, dims, tconfig)
    g_t = dict(zip(p_t, torch.autograd.grad(loss_t, list(p_t.values()))))
    for k in p_t:
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(
            g_t[k].numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
            err_msg=k,
        )
    m_t = tppo._update_from_traj(traj_t, boot_t, p_t,
                                 tppo._optimizer(p_t, tconfig), dims, tconfig)
    n_updates = config.n_epochs * config.n_minibatches
    for k in p_t:
        got, want = p_t[k].detach().numpy(), np.asarray(p_j2[k])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * config.lr * n_updates, err_msg=k)
        sure = np.abs(np.asarray(g_j[k])) > 1e-3 * np.abs(np.asarray(g_j[k])).max()
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(got, p_np[k]) or k == "mlp_b1"
    for k in ("policy_loss", "value_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(m_t["episodes"]) == float(m_j["episodes"]) > 0


def test_evaluate_exact_episode_returns():
    tf = TF(TEnv(max_iterations=6))
    params = tppo.init_params(6, tf.amax - tf.amin + 1, 8,
                              torch.Generator().manual_seed(1), "cpu")
    out = tppo.evaluate(tf, params, n_steps=24, batch=8, seed=4, device="cpu")
    _, traj, _ = tf.rollout_collect(tf.init_packed(4, 8, "cpu"), params, 24)
    reward = traj["reward"].numpy()
    done = traj["done"].numpy() > 0
    T, n, B = reward.shape
    rets = []
    for j in range(n):
        for b in range(B):
            acc, prev = 0.0, False
            for t in range(T):
                acc += reward[t, j, b]
                if done[t, j, b] and not prev:
                    rets.append(acc)
                if done[t, j, b]:
                    acc = 0.0
                prev = done[t, j, b]
    assert out["episodes"] == len(rets) > 0
    np.testing.assert_allclose(out["mean_episode_return"], np.mean(rets),
                               rtol=1e-5)
    assert out["env_steps"] == 24 * 8


def test_train_step_on_the_cpu_runs_and_updates():
    tf = TF(TEnv(max_iterations=8))
    config = tppo.FusedPPOConfig(n_steps=6, n_epochs=2, n_minibatches=2,
                                 hidden=16)
    state = tppo.init_train_state(tf, 16, seed=1, config=config, device="cpu")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = tppo.make_train_step(tf, config, device="cpu")
    state, metrics = step(state)
    state, metrics = step(state)
    assert state.update_idx == 2
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert max(float((state.params[k].detach() - p0[k]).abs().max())
               for k in p0) > 0
    assert int(state.S["draw_ctr"].to(torch.int64).max()) == 2 * config.n_steps
    # The same seed draws the same params.
    again = tppo.init_train_state(tf, 16, seed=1, config=config, device="cpu")
    for k in p0:
        assert torch.equal(again.params[k].detach(), p0[k])


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    tf = TF(TEnv())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tppo.make_train_step(tf, tppo.FusedPPOConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tppo.init_train_state(tf, 8)  # device="cuda" by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tppo.evaluate(tf, {}, n_steps=1, batch=1)

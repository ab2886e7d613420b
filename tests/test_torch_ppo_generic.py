"""The port's generic PPO learner (``learners/ppo.py``) against the JAX
package's on island_navigation, from the same keys and carried states.

- ``init_train_state`` from a key: the params within 3 ulps
  (``threefry.normal``), the episodes and the run's key equal.
- The port form of ``tests/test_ppo_learning.py::
  test_gae_and_loss_generic_match_numpy``: GAE and the loss on a recorded
  trajectory against the float64 numpy oracle (GAE within 1e-4; the loss
  within 1e-5 relative + 2e-4, the JAX gate's bounds).
- ``_collect`` from a carried state at B = 64: the actions equal except on
  lanes whose two largest perturbed logits lie within ``GAP`` = 1e-5 of
  each other (counted; none at this seed), obs/reward/cont/valid exact,
  logp, value and the bootstrap within 1e-5; ``adv``/``ret`` within 1e-4
  (JAX's gate, ``tests/test_ppo_learning.py:224``); the gradients of
  ``_loss`` on JAX's trajectory against ``jax.grad`` under
  ``test_torch_actor_critic``'s bounds (the bfloat16 path's within one
  bfloat16 ulp of the largest entry and 1e-4 in the L2 norm, the heads'
  within 1e-5 of the largest entry).
- One ``train_step`` from a carried ``PPOState`` (one JAX update in, so
  that the Adam moments are live) at B = 64: the params within 1e-5 (seen:
  2.2e-6; lr 7e-4 over 16 updates), the Adam count equal and the moments
  within 1e-3 of each one's largest entry on the bfloat16 path (seen:
  4.4e-4) and 1e-4 elsewhere (seen: 1.5e-5; torch's Adam rounds in
  another order than optax's), the metrics within 1e-4 relative, the
  episodes and the key equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.envs.island_navigation import (
    IslandNavigation as JEnv,
)
from ai_safety_gridworlds_tpu.learners import ppo as jppo
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.envs.island_navigation import (
    IslandNavigation as TEnv,
)
from ai_safety_gridworlds_torch.learners import actor_critic as tac
from ai_safety_gridworlds_torch.learners import ppo as tppo
from test_torch_ppo_fused import np_gae, np_ppo_loss

B = 64
GAP = 1e-5
BF16_PATH = ("w1", "b1", "w2")
CONFIG = dict(n_steps=32, hidden=128, lr=7e-4)


def _configs(**kw):
    j = jppo.PPOConfig(**kw)
    return j, tppo.PPOConfig(**j._asdict())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_ep_equal(jep, tep, lanes=slice(None)):
    for f in ("t", "key", "pos", "safety"):
        want = np.asarray(getattr(jep.env_state, f)).astype(np.int64)[lanes]
        got = getattr(tep.env_state, f).cpu().numpy().astype(np.int64)[lanes]
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("last_step_type", "episode_return", "hidden_return"):
        np.testing.assert_array_equal(
            getattr(tep, f).cpu().numpy()[lanes],
            np.asarray(getattr(jep, f))[lanes], err_msg=f)


def test_init_train_state_matches_jax():
    jcfg, tcfg = _configs(**CONFIG)
    js = jppo.init_train_state(JEnv(), jax.random.PRNGKey(3), batch_size=B,
                               config=jcfg)
    ts = tppo.init_train_state(TEnv(), 3, B, tcfg, device="cpu")
    for f in tac.ACParams._fields:
        want = np.asarray(getattr(js.params, f))
        got = getattr(ts.params, f).detach().numpy()
        ulps = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32).astype(np.int64))
        assert ulps.max() <= 3, f
    _assert_ep_equal(js.ep_batch, ts.ep_batch)
    np.testing.assert_array_equal(ts.key.numpy(),
                                  np.asarray(js.key).astype(np.int64))
    assert ts.update_idx == 0 and not ts.opt.state


def test_gae_and_loss_generic_match_numpy():
    _, config = _configs(n_steps=16, hidden=32)
    env = TEnv()
    state = tppo.init_train_state(env, 2, 8, config, device="cpu")
    _, traj, boot = tppo._collect(state.params, env, state.ep_batch,
                                  threefry.PRNGKey(7), config)
    traj = {k: v.numpy() for k, v in traj.items()}
    boot = boot.numpy()
    adv_t, ret_t = tppo._gae(
        {k: torch.from_numpy(traj[k]) for k in ("reward", "value", "cont")},
        torch.from_numpy(boot), config)
    adv_n, ret_n = np_gae(
        traj["reward"].astype(np.float64), traj["value"].astype(np.float64),
        traj["cont"].astype(np.float64), boot.astype(np.float64),
        config.discount, config.gae_lambda)
    np.testing.assert_allclose(adv_t.numpy(), adv_n, atol=1e-4)
    np.testing.assert_allclose(ret_t.numpy(), ret_n, atol=1e-4)
    assert (traj["cont"] == 0.0).any()  # episode boundaries exercised

    T, Bt = traj["reward"].shape
    mb = {
        "obs": torch.from_numpy(traj["obs"].reshape(T * Bt, -1)),
        "action": torch.from_numpy(traj["action"].reshape(T * Bt)),
        "logp": torch.from_numpy(traj["logp"].reshape(T * Bt)),
        "valid": torch.from_numpy(traj["valid"].reshape(T * Bt)),
        "adv": torch.from_numpy(adv_n.astype(np.float32).reshape(T * Bt)),
        "ret": torch.from_numpy(ret_n.astype(np.float32).reshape(T * Bt)),
    }
    with torch.no_grad():
        loss_t, metrics_t = tppo._loss(state.params, mb, config)
        logits, value = tac.forward(state.params, mb["obs"])
    # The loss composition in float64 numpy on the port's own forward.
    out_n = np_ppo_loss(
        logits.numpy().astype(np.float64), value.numpy().astype(np.float64),
        traj["action"].reshape(T * Bt),
        traj["logp"].astype(np.float64).reshape(T * Bt),
        traj["valid"].astype(np.float64).reshape(T * Bt),
        adv_n.reshape(T * Bt), ret_n.reshape(T * Bt), config)
    np.testing.assert_allclose(float(loss_t), out_n["loss"], rtol=1e-5,
                               atol=2e-4)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(metrics_t[k]), out_n[k], rtol=1e-5,
                                   atol=2e-4, err_msg=k)
    assert (traj["valid"] == 0).any()


@pytest.fixture(scope="module")
def carried():
    """A JAX state one update in (16 Adam steps: live moments), its port
    form, and JAX's next update from it."""
    jcfg, tcfg = _configs(**CONFIG)
    env = JEnv()
    js = jppo.init_train_state(env, jax.random.PRNGKey(0), batch_size=B,
                               config=jcfg)
    step = jppo.make_train_step(env, jcfg)
    js, _ = step(js)
    js2, jm = step(js)
    ts = tppo.state_from_jax(TEnv(), _np(js), tcfg, device="cpu")
    return jcfg, tcfg, js, ts, js2, jm


def test_state_from_jax_carries_everything(carried):
    _, _, js, ts, _, _ = carried
    for f in tac.ACParams._fields:
        np.testing.assert_array_equal(getattr(ts.params, f).detach().numpy(),
                                      np.asarray(getattr(js.params, f)))
    moments = tppo._adam_moments(js.opt_state)
    for f, p in zip(tac.ACParams._fields, ts.params):
        st = ts.opt.state[p]
        assert float(st["step"]) == int(moments.count) == 16
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(getattr(moments.mu, f)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(moments.nu, f)))
    _assert_ep_equal(js.ep_batch, ts.ep_batch)
    assert ts.update_idx == 1


def test_collect_gae_and_loss_gradients_match_jax(carried):
    jcfg, tcfg, js, ts, _, _ = carried
    key = 11
    jep, jtraj, jboot = jax.jit(functools.partial(
        jppo._collect, env=JEnv(), config=jcfg))(
            js.params, ep_batch=js.ep_batch, key=jax.random.PRNGKey(key))
    jtraj = _np(jtraj)
    gaps = []
    tep, ttraj, tboot = tppo._collect(ts.params, TEnv(), ts.ep_batch,
                                      threefry.PRNGKey(key), tcfg,
                                      draw_gaps=gaps)
    near = (torch.stack(gaps) < GAP).any(dim=0).numpy()
    print(f"lanes with a perturbed-logit gap below {GAP}: {near.sum()}")
    assert near.sum() <= 0.01 * B
    keep = ~near
    for k in ("obs", "action", "reward", "cont", "valid"):
        np.testing.assert_array_equal(ttraj[k].numpy()[:, keep],
                                      jtraj[k][:, keep], err_msg=k)
    for k in ("logp", "value"):
        np.testing.assert_allclose(ttraj[k].numpy()[:, keep],
                                   jtraj[k][:, keep], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tboot.numpy()[keep], np.asarray(jboot)[keep],
                               rtol=0, atol=1e-5)
    _assert_ep_equal(jep, tep, keep)
    assert (jtraj["valid"] == 0).any() and (jtraj["cont"] == 0).any()

    adv_j, ret_j = jppo._gae({k: jnp.asarray(jtraj[k]) for k in
                              ("reward", "value", "cont")}, jboot, jcfg)
    adv_t, ret_t = tppo._gae(ttraj, tboot, tcfg)
    np.testing.assert_allclose(adv_t.numpy()[:, keep],
                               np.asarray(adv_j)[:, keep], atol=1e-4)
    np.testing.assert_allclose(ret_t.numpy()[:, keep],
                               np.asarray(ret_j)[:, keep], atol=1e-4)

    # The gradients of the loss on JAX's own trajectory (one minibatch).
    T = jtraj["reward"].shape[0]
    n = T * B // 4
    mb_j = {
        "obs": jtraj["obs"].reshape(T * B, -1)[:n],
        "action": jtraj["action"].reshape(-1)[:n],
        "logp": jtraj["logp"].reshape(-1)[:n],
        "valid": jtraj["valid"].reshape(-1)[:n],
        "adv": np.asarray(adv_j).reshape(-1)[:n],
        "ret": np.asarray(ret_j).reshape(-1)[:n],
    }
    g_j = jax.grad(jppo._loss, has_aux=True)(js.params, mb_j, jcfg)[0]
    mb_t = {k: torch.from_numpy(np.array(v)) for k, v in mb_j.items()}
    loss_t, _ = tppo._loss(ts.params, mb_t, tcfg)
    g_t = torch.autograd.grad(loss_t, list(ts.params))
    for f, g in zip(tac.ACParams._fields, g_t):
        want, got = np.asarray(getattr(g_j, f)), g.numpy()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        if f in BF16_PATH:
            assert diff.max() <= 2.0**-7 * scale, (f, diff.max(), scale)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (f, rel)
        else:
            assert diff.max() <= 1e-5 * scale, (f, diff.max(), scale)


def test_train_step_from_a_carried_state(carried):
    _, tcfg, js, _, js2, jm = carried
    # A state of its own: the step updates the params in place.
    ts = tppo.state_from_jax(TEnv(), _np(js), tcfg, device="cpu")
    gaps = []
    step = tppo.make_train_step(TEnv(), tcfg, device="cpu", draw_gaps=gaps)
    ts2, tm = step(ts)
    near = (torch.stack(gaps) < GAP).any(dim=0)
    print(f"lanes with a perturbed-logit gap below {GAP}: {int(near.sum())}")
    # Every lane drew JAX's actions: the comparisons below need them all.
    assert not near.any()
    _assert_ep_equal(js2.ep_batch, ts2.ep_batch)
    np.testing.assert_array_equal(ts2.key.numpy(),
                                  np.asarray(js2.key).astype(np.int64))
    assert ts2.update_idx == int(js2.update_idx) == 2
    moments = tppo._adam_moments(js2.opt_state)
    for f, p in zip(tac.ACParams._fields, ts2.params):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(getattr(js2.params, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
        st = ts2.opt.state[p]
        assert float(st["step"]) == int(moments.count)
        rel = 1e-3 if f in BF16_PATH else 1e-4
        for name, m in (("exp_avg", moments.mu), ("exp_avg_sq", moments.nu)):
            want = np.asarray(getattr(m, f))
            np.testing.assert_allclose(st[name].numpy(), want, rtol=0,
                                       atol=rel * np.abs(want).max(),
                                       err_msg=f"{f} {name}")
    for k in ("policy_loss", "value_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(tm["episodes"]) == float(jm["episodes"]) > 0


def test_devices_are_explicit():
    _, tcfg = _configs(n_steps=2, hidden=8)
    state = tppo.init_train_state(TEnv(), 0, 8, tcfg, device="cpu")
    step = tppo.make_train_step(TEnv(), tcfg, device="meta")
    with pytest.raises(ValueError, match="train state lies on"):
        step(state)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for fn in (lambda: tppo.init_train_state(TEnv(), 0, 8, tcfg),
               lambda: tppo.make_train_step(TEnv(), tcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()

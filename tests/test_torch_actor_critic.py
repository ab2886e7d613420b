"""The port's A2C learner (``learners/actor_critic.py``) against the JAX
package's on island_navigation, from the same keys and carried params.

Tolerances:

- ``init_params`` from a key: within 3 ulps of JAX's (``threefry.normal``).
- ``forward``: logits and values within 1e-5 of the largest (float32 sums
  in another order; the bfloat16 operands are exact).
- The gradients of ``unroll_and_loss`` (the same keys draw the same
  actions; the test checks the episodes went the same way): the heads'
  and ``b2``'s within 1e-5 of each one's largest entry. ``w1``, ``b1`` and
  ``w2`` pass through JAX's bfloat16 cotangent roundings, where a sum that
  lies on a rounding boundary may round the other way in the port: each
  entry within one bfloat16 ulp (2**-7) of the largest, the whole within
  1e-4 relative in the L2 norm (seen: 1.3e-5, ``b1``; a flip moves one
  summand of hundreds by one bfloat16 ulp).
- Three ``train_step``s from carried params: the params within 1e-5 and
  the losses within 1e-5 relative.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_tpu.core import base as jbase
from ai_safety_gridworlds_tpu.envs.island_navigation import (
    IslandNavigation as JEnv,
)
from ai_safety_gridworlds_tpu.learners import actor_critic as jac
from ai_safety_gridworlds_torch.core import base as tbase
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.envs.island_navigation import (
    IslandNavigation as TEnv,
)
from ai_safety_gridworlds_torch.learners import actor_critic as tac
from torch_threads import one_torch_thread  # noqa: F401

B, T = 64, 8
OBS_DIM = 6 * 8
BF16_PATH = ("w1", "b1", "w2")


def _carried(hidden, seed=1):
    jp = jac.init_params(jax.random.PRNGKey(seed), OBS_DIM, 4, hidden=hidden)
    return jp, tac.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _episodes(seed):
    jep = jax.vmap(functools.partial(jbase.episode_reset, JEnv()))(
        jax.random.split(jax.random.PRNGKey(seed), B))
    tep = tbase.episode_reset(TEnv(), threefry.split(
        threefry.PRNGKey(seed), B))
    return jep, tep


@pytest.mark.parametrize("hidden", [256, 32])
def test_init_params_from_a_key(hidden):
    jp = jac.init_params(jax.random.PRNGKey(4), OBS_DIM, 4, hidden=hidden)
    tp = tac.init_params(4, OBS_DIM, 4, hidden=hidden, device="cpu")
    for f in tac.ACParams._fields:
        want, got = np.asarray(getattr(jp, f)), getattr(tp, f)
        assert got.is_leaf and got.requires_grad
        got = got.detach().numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        ulps = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32).astype(np.int64))
        assert ulps.max() <= 3, (f, ulps.max())


def test_forward_matches_jax():
    jp, tp = _carried(256)
    rng = np.random.default_rng(0)
    # Board values (small integers) and the PPO learner's centred form.
    for obs in (rng.integers(0, 6, (B, OBS_DIM)).astype(np.float32),
                rng.integers(0, 6, (B, OBS_DIM)).astype(np.float32) / 64 - 1,
                rng.normal(size=(B, OBS_DIM)).astype(np.float32)):
        lj, vj = jac.forward(jp, obs)
        lt, vt = tac.forward(tp, torch.from_numpy(obs))
        for want, got in ((lj, lt), (vj, vt)):
            want = np.asarray(want)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def _assert_grads_close(gj, gt):
    for f, g in zip(tac.ACParams._fields, gt):
        want, got = np.asarray(getattr(gj, f)), g.numpy()
        scale = np.abs(want).max()
        assert scale > 0, f
        diff = np.abs(got - want)
        if f in BF16_PATH:
            assert diff.max() <= 2.0**-7 * scale, (f, diff.max(), scale)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (f, rel)
        else:
            assert diff.max() <= 1e-5 * scale, (f, diff.max(), scale)


def test_unroll_and_loss_gradients_match_jax_grad():
    jp, tp = _carried(256)
    jep, tep = _episodes(2)
    (loss_j, jep2), gj = jax.value_and_grad(
        jac.unroll_and_loss, has_aux=True)(
            jp, JEnv(), jep, jax.random.PRNGKey(3), n_steps=T)
    loss_t, tep2 = tac.unroll_and_loss(tp, TEnv(), tep, 3, n_steps=T)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    # The same actions: the episodes went the same way.
    for f in ("pos", "t", "key"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jep2.env_state, f)).astype(np.int64),
            getattr(tep2.env_state, f).numpy().astype(np.int64))
    _assert_grads_close(gj, torch.autograd.grad(loss_t, list(tp)))


def test_train_steps_from_carried_params():
    jp, tp = _carried(256, seed=5)
    jep, tep = _episodes(6)
    step = jax.jit(lambda p, e, k: jac.train_step(p, JEnv(), e, k,
                                                  n_steps=T))
    env = TEnv()
    for s in range(3):
        jp, jep, loss_j = step(jp, jep, jax.random.PRNGKey(10 + s))
        tp_new, tep, loss_t = tac.train_step(tp, env, tep,
                                             threefry.PRNGKey(10 + s),
                                             n_steps=T)
        assert all(a is not b for a, b in zip(tp, tp_new))
        tp = tp_new
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        for f in tac.ACParams._fields:
            np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                       np.asarray(getattr(jp, f)), rtol=0,
                                       atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np.asarray(jep.env_state.pos),
                                  tep.env_state.pos.numpy())


def test_episodes_on_another_device_than_the_params_refused():
    _, tp = _carried(32)
    _, tep = _episodes(1)
    meta = tac.ACParams(*(p.detach().to("meta") for p in tp))
    with pytest.raises(ValueError, match="params lie on"):
        tac.unroll_and_loss(meta, TEnv(), tep, 0, n_steps=1)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tac.init_params(0, OBS_DIM, 4, device="cuda")

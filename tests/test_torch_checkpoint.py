"""The port's checkpoints (``utils/checkpoint.py``): the port form of
``tests/test_ppo_checkpoint.py``, with the fused learner's Adam state, and a
JAX train state carried into the port.

* A generic PPO state round-trips bit-exactly into a template of another
  key; training resumed from a checkpoint equals training straight through,
  bit for bit (params, Adam's moments and count, episodes, key), for the
  generic and the fused learner.
* The manager keeps the last ``max_to_keep`` steps on its interval, skips
  the rest, ignores a half-written step and refuses to overwrite one.
* A fused-PPO state after two JAX steps, carried in with
  ``interop.fused_ppo_state_from_numpy`` and stepped twice in the port,
  agrees with JAX's four steps: ``S`` exactly and the metrics within rtol
  1e-4 when no action draw of the port's collections came within 1e-6 of a
  CDF boundary (else only on the other lanes), the params within 2 * lr per
  update (``tests/test_torch_ppo_fused.py``'s bound), Adam's count equal.

The sharded round trip on two ranks is in
``tests/test_torch_parallel_ppo.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.island_navigation import IslandNavigation
from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_torch.learners import ppo, ppo_fused
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401

SMALL = ppo.PPOConfig(n_steps=8, n_epochs=2, n_minibatches=2, hidden=32)
FUSED = dict(n_steps=4, n_epochs=1, n_minibatches=2, hidden=8)
CDF_GAP = 1e-6


def leaves(tree):
    out, opts = [], []
    ckpt._flatten(tree, out, opts)
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                out += [v for _, v in sorted(opt.state[p].items())]
    return out


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x.detach(), y.detach())
        else:
            assert x == y


def test_checkpoint_roundtrip(tmp_path):
    env = IslandNavigation()
    state = ppo.init_train_state(env, 3, batch_size=4, config=SMALL,
                                 device="cpu")
    step = ppo.make_train_step(env, SMALL, device="cpu")
    state, _ = step(state)  # Adam's state exists
    ckpt.save_pytree(str(tmp_path / "ckpt"), state)
    template = ppo.init_train_state(env, 9, batch_size=4, config=SMALL,
                                    device="cpu")
    restored = ckpt.restore_pytree(str(tmp_path / "ckpt"), template)
    assert_same(state, restored)
    # The optimizer is a new one over the restored params.
    assert restored.opt.param_groups[0]["params"][0] is restored.params[0]
    assert restored.opt is not state.opt and restored.opt is not template.opt
    with pytest.raises(FileExistsError, match="already holds"):
        ckpt.save_pytree(str(tmp_path / "ckpt"), state)


def test_resume_determinism(tmp_path):
    env = IslandNavigation()
    step = ppo.make_train_step(env, SMALL, device="cpu")

    def fresh():
        return ppo.init_train_state(env, 0, batch_size=16, config=SMALL,
                                    device="cpu")

    straight = fresh()
    for _ in range(4):
        straight, _ = step(straight)
    half = fresh()
    for _ in range(2):
        half, _ = step(half)
    ckpt.save_pytree(str(tmp_path / "mid"), half)
    resumed = ckpt.restore_pytree(str(tmp_path / "mid"), fresh())
    for _ in range(2):
        resumed, _ = step(resumed)
    assert resumed.update_idx == straight.update_idx == 4
    assert_same(straight, resumed)


def test_fused_resume_determinism_with_adam_state(tmp_path):
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    config = ppo_fused.FusedPPOConfig(**FUSED)
    step = ppo_fused.make_train_step(fused, config, device="cpu")

    def fresh():
        return ppo_fused.init_train_state(fused, 16, seed=1, config=config,
                                          device="cpu")

    straight = fresh()
    for _ in range(3):
        straight, _ = step(straight)
    half = fresh()
    half, _ = step(half)
    with ckpt.CheckpointManager(str(tmp_path / "mgr")) as mgr:
        mgr.save(1, half)
        resumed = mgr.restore(mgr.latest_step(), fresh())
    for p in resumed.params.values():
        assert int(resumed.opt.state[p]["step"]) == (
            config.n_epochs * config.n_minibatches)
    for _ in range(2):
        resumed, _ = step(resumed)
    assert_same(straight, resumed)


def test_checkpoint_manager_retention(tmp_path):
    env = IslandNavigation()
    state = ppo.init_train_state(env, 1, batch_size=2, config=SMALL,
                                 device="cpu")
    with ckpt.CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2,
                                save_interval_steps=2) as mgr:
        assert mgr.latest_step() is None
        saved = [mgr.save(i, state) for i in range(7)]
        assert saved == [True, False, True, False, True, False, True]
        assert mgr.latest_step() == 6 and mgr.all_steps() == [4, 6]
        restored = mgr.restore(6, ppo.init_train_state(
            env, 5, batch_size=2, config=SMALL, device="cpu"))
        assert_same(state, restored)
        # A save cut off before its rename is no step.
        os.makedirs(tmp_path / "mgr" / "8.tmp")
        assert mgr.latest_step() == 6
        mgr.save(8, state)  # the leftover is cleared
        assert mgr.all_steps() == [6, 8]
        with pytest.raises(FileExistsError):
            mgr.save(8, state)


def near_cdf(fused, S, params, n_steps):
    """Lanes whose collection from ``S`` under ``params`` draws within
    CDF_GAP of a cumulative softmax sum (the plain step's ``cdf_gap``)."""
    statics = fused._collect_statics(S, params)
    near = torch.zeros(S["t"].shape[1], dtype=torch.bool)
    for _ in range(n_steps):
        S, _, ex = fused._collect_step(S, statics)
        near |= (ex["pol"]["cdf_gap"] < CDF_GAP).any(dim=0)
    return near


def test_jax_state_resumes_in_the_port():
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa as JEnv,
    )
    from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa as JF

    jconfig = jppo.FusedPPOConfig(**FUSED)
    jf = JF(JEnv(max_iterations=6))
    jstate = jppo.init_train_state(jf, jax.random.PRNGKey(4), 16, seed=2,
                                   config=jconfig)
    jstep = jppo.make_train_step(jf, jconfig, backend="xla")
    for _ in range(2):
        jstate, _ = jstep(jstate)
    carried = jax.tree.map(np.asarray, jstate)
    for _ in range(2):
        jstate, jmetrics = jstep(jstate)

    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=6))
    fused.init_packed(2, 16, "cpu")
    config = ppo_fused.FusedPPOConfig(**FUSED)
    moments = ppo._adam_moments(carried.opt_state)
    state = interop.fused_ppo_state_from_numpy(
        fused, carried.params, moments.mu, moments.nu, moments.count,
        carried.S, config, "cpu", update_idx=int(carried.update_idx))
    step = ppo_fused.make_train_step(fused, config, device="cpu")
    exempt = torch.zeros(16, dtype=torch.bool)
    for _ in range(2):
        exempt |= near_cdf(fused, state.S, state.params, config.n_steps)
        state, metrics = step(state)
    assert state.update_idx == int(jstate.update_idx) == 4
    assert int(exempt.sum()) <= 2, f"{int(exempt.sum())} near-CDF lanes"
    keep = ~exempt.numpy()
    for k, v in state.S.items():
        np.testing.assert_array_equal(v.numpy()[:, keep],
                                      np.asarray(jstate.S[k])[:, keep],
                                      err_msg=k)
    n_updates = 2 * config.n_epochs * config.n_minibatches
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstate.params[k]), rtol=0,
                                   atol=2 * config.lr * n_updates, err_msg=k)
        assert int(state.opt.state[p]["step"]) == int(
            ppo._adam_moments(jstate.opt_state).count)
    if not exempt.any():
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(jmetrics[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)

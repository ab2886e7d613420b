"""The port's data-parallel learners in real CPU processes on gloo, against
the JAX package and the one-process port.

One run of ``tests/torch_multihost_worker.py ppo`` at two ranks and one at
four (a file store under ``tmp_path``; 60 s rendezvous, 180 s for the whole
group, which is killed on expiry) gives:

* ``make_sharded_train_step`` on island_navigation_ex_ma (per-lane layouts)
  at two ranks against JAX's ``make_sharded_train_step(...,
  backend="xla")`` on a two-device mesh, both from one JAX state carried
  across with ``interop.fused_ppo_state_from_numpy``. ``S`` exact except on
  lanes whose action draw came within 1e-6 of a CDF boundary (counted);
  metrics within rtol 1e-4; params within ``tests/test_torch_ppo_fused.py``'s
  bound: 2 * lr per update everywhere, 1e-6 where the first-minibatch
  gradient (the mean of the two ranks', from the port's replay of the
  collection) is well above its rounding;
* a sharded checkpoint round trip after one step, whose resume is
  bit-equal to running straight through (two ranks);
* the compose-time refusals of ``tests/test_multichip_dryrun.py`` and the
  statics guard (four ranks), and its uneven but valid composition (two);
* A2C's ``train_step`` under a ``(1, 2)`` and a ``(2, 2)`` mesh, each rank
  holding half the hidden units, against the one-process step: each
  param's gradient (its change over the learning rate) within one bfloat16
  ulp of its largest entry, the bound ``tests/test_torch_actor_critic.py``
  holds the gradients to JAX by (the second layer's sums meet over the
  ranks in another order, and a cotangent one float32 ulp away may round to
  another bfloat16 value), the loss within 1e-5 relative, the ranks of one
  model index bit-equal.

A one-rank mesh's sharded step is bit-equal to ``make_train_step`` (this
process, no process group).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multihost_worker as W  # noqa: E402

SEED = 3
CDF_GAP = 1e-6
A2C_LR = 1e-3  # train_step's default, which the workers use


def jax_engine():
    from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_tpu.ops.fused_island_ma import FusedIslandMa

    return FusedIslandMa(IslandNavigationExMa(**W.PPO_ENV_KW))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX start state and sharded step, and the two worker runs'
    directories."""
    from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
    from ai_safety_gridworlds_tpu.parallel import mesh as jmesh

    from ai_safety_gridworlds_torch.learners.ppo import _adam_moments

    config = jppo.FusedPPOConfig(**W.PPO_KW)
    jf = jax_engine()
    state = jppo.init_train_state(jf, jax.random.PRNGKey(7), W.BATCH,
                                  seed=SEED, config=config)
    moments = _adam_moments(state.opt_state)
    dirs = {w: str(tmp_path_factory.mktemp(f"ppo{w}")) for w in (2, 4)}
    np.savez(
        os.path.join(dirs[2], "start.npz"), seed=SEED,
        count=np.asarray(moments.count),
        **{f"params.{k}": np.asarray(v) for k, v in state.params.items()},
        **{f"mu.{k}": np.asarray(v) for k, v in moments.mu.items()},
        **{f"nu.{k}": np.asarray(v) for k, v in moments.nu.items()},
        **{f"S.{k}": np.asarray(v) for k, v in state.S.items()},
    )
    groups = {w: W.start_group("ppo", w, dirs[w]) for w in (2, 4)}
    try:
        train_step, shard_state = jppo.make_sharded_train_step(
            jf, jmesh.make_mesh(n_data=2), config=config, backend="xla")
        after, metrics = train_step(shard_state(state))
        jax_out = {
            "start": state, "params": jax.tree.map(np.asarray, after.params),
            "S": jax.tree.map(np.asarray, after.S),
            "metrics": jax.tree.map(np.asarray, metrics),
        }
    finally:
        for w in (2, 4):
            W.wait_group(groups[w], f"ppo world {w}")
    return dirs, jax_out


def port_replay(jax_state, config):
    """The port's collection from the start state, replayed on the whole
    batch (lanes are independent): the lanes with a draw within CDF_GAP of
    a cumulative softmax sum (the plain step's ``cdf_gap``), and the
    two-rank step's first minibatch gradient (each rank's lanes, its GAE
    and first lane block, the mean over the ranks) as numpy by param."""
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.learners import ppo_fused as tppo
    from ai_safety_gridworlds_torch.ops import interop
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa

    tf = FusedIslandMa(IslandNavigationExMa(**W.PPO_ENV_KW))
    tf.init_packed(SEED, W.BATCH, "cpu")
    S = interop.state_from_numpy(jax.tree.map(np.asarray, jax_state.S), "cpu")
    params = {k: v.requires_grad_() for k, v in interop.params_from_numpy(
        jax.tree.map(np.asarray, jax_state.params), "cpu").items()}
    statics = tf._collect_statics(S, params)
    near = torch.zeros(W.BATCH, dtype=torch.bool)
    recs = []
    for _ in range(config.n_steps):
        S, rec, ex = tf._collect_step(S, statics)
        recs.append(rec)
        near |= (ex["pol"]["cdf_gap"] < CDF_GAP).any(dim=0)
    traj = {k: torch.stack([r[k] for r in recs]) for k in recs[0]}
    boot = tf._bootstrap_value(S, statics)
    local = W.BATCH // 2
    grads = []
    for r in range(2):
        lanes = slice(r * local, (r + 1) * local)
        mb = tppo._minibatches({k: v[..., lanes] for k, v in traj.items()},
                               boot[:, lanes], config)[0]
        loss, _ = tppo._loss_packed(params, mb, tppo._dims(tf), config)
        grads.append(torch.autograd.grad(loss, list(params.values())))
    grad = {k: ((a + b) / 2).numpy()
            for k, a, b in zip(params, grads[0], grads[1])}
    return near.numpy(), grad


def rank_files(out_dir, world, stem):
    return [np.load(os.path.join(out_dir, f"{stem}_rank{r}.npz"))
            for r in range(world)]


def test_sharded_train_step_matches_jax(runs):
    dirs, jx = runs
    config = W.PPO_KW
    parts = rank_files(dirs[2], 2, "ppo")
    from ai_safety_gridworlds_torch.learners import ppo_fused as tppo

    exempt, grad = port_replay(jx["start"], tppo.FusedPPOConfig(**config))
    assert exempt.sum() <= W.BATCH // 8, f"{exempt.sum()} near-CDF lanes"
    for k, want in jx["S"].items():
        got = np.concatenate([p[f"S.{k}"] for p in parts], axis=1)
        np.testing.assert_array_equal(got[:, ~exempt], want[:, ~exempt],
                                      err_msg=k)
    for p in parts[1:]:  # replicated params
        for k in jx["params"]:
            np.testing.assert_array_equal(p[f"params.{k}"],
                                          parts[0][f"params.{k}"])
    lr, n_updates = 3e-4, config["n_epochs"] * config["n_minibatches"]
    start = jax.tree.map(np.asarray, jx["start"].params)
    for k, want in jx["params"].items():
        got = parts[0][f"params.{k}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * n_updates,
                                   err_msg=k)
        g = np.abs(grad[k])
        sure = g > 1e-3 * g.max()
        if not exempt.any():
            np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                       atol=1e-6, err_msg=k)
        assert not np.array_equal(got, start[k]) or k == "mlp_b1"
    for k, want in jx["metrics"].items():
        np.testing.assert_allclose(parts[0][f"metrics.{k}"], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(jx["metrics"]["episodes"]) > 0


def test_sharded_checkpoint_resume_is_bit_exact(runs):
    dirs, _ = runs
    for r in range(2):
        with open(os.path.join(dirs[2], f"resume_rank{r}.json")) as f:
            out = json.load(f)
        assert out == {"bit_equal": True, "update_idx": 2}, (r, out)
    ckpt = os.path.join(dirs[2], "ckpt", "1")
    assert sorted(os.listdir(ckpt)) == ["shard0.pt", "shard1.pt"]


def test_sharded_step_uneven_but_valid_composition_runs(runs):
    dirs, _ = runs
    for r in range(2):
        with open(os.path.join(dirs[2], f"uneven_rank{r}.json")) as f:
            assert json.load(f) == {"update_idx": 1, "lanes": 6,
                                    "finite": True}


def test_sharded_step_refusals(runs):
    dirs, _ = runs
    for r in range(4):
        with open(os.path.join(dirs[4], f"refusals_rank{r}.json")) as f:
            got = json.load(f)
        assert "not divisible by the mesh" in got["batch"], got
        assert "n_minibatches" in got["minibatch"], got
        assert "lane tile" in got["tile"], got
        assert "re-packed" in got["statics"], got


def a2c_reference():
    """The one-process A2C step of the workers' configuration."""
    from ai_safety_gridworlds_torch.core import base, threefry
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.learners import actor_critic as ac

    env = IslandNavigation()
    params = ac.init_params(1, 48, env.action_max - env.action_min + 1,
                            hidden=W.A2C_HIDDEN, device="cpu")
    ep = base.episode_reset(env, threefry.split(threefry.PRNGKey(2, "cpu"),
                                                W.A2C_BATCH))
    gaps = []
    new, _, loss = ac.train_step(params, env, ep, 3, lr=A2C_LR,
                                 n_steps=W.A2C_STEPS, draw_gaps=gaps)
    grads = {f: (getattr(params, f) - getattr(new, f)).detach().numpy() / A2C_LR
             for f in new._fields}
    return new, grads, loss, float(torch.stack(gaps).min())


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_a2c_under_a_model_mesh_matches_one_process(runs, shape):
    dirs, _ = runs
    n_data, n_model = map(int, shape.split("x"))
    world = n_data * n_model
    parts = rank_files(dirs[world], world, f"a2c_{shape}")
    ref, grads, loss, gap = a2c_reference()
    assert gap > 1e-5 and all(float(p["min_gap"]) > 1e-5 for p in parts)
    hidden = W.A2C_HIDDEN
    for r, p in enumerate(parts):
        assert p["w1"].shape == (48, hidden // n_model)
        assert p["b1"].shape == (hidden // n_model,)
        assert p["w2"].shape == (hidden // n_model, hidden)
        # The ranks of one model index hold the same shards.
        np.testing.assert_array_equal(p["w1"], parts[r % n_model]["w1"])
        np.testing.assert_array_equal(p["w2"], parts[r % n_model]["w2"])
        np.testing.assert_array_equal(p["w_pi"], parts[0]["w_pi"])
    got = {
        "w1": np.concatenate([parts[m]["w1"] for m in range(n_model)], 1),
        "b1": np.concatenate([parts[m]["b1"] for m in range(n_model)]),
        "w2": np.concatenate([parts[m]["w2"] for m in range(n_model)], 0),
    }
    for f in ref._fields:
        want = getattr(ref, f).detach().numpy()
        bf16_ulp = 2.0 ** -8 * np.abs(grads[f]).max()
        np.testing.assert_allclose(got.get(f, parts[0][f]), want, rtol=0,
                                   atol=A2C_LR * bf16_ulp, err_msg=f)
    np.testing.assert_allclose(parts[0]["loss"], float(loss), rtol=1e-5)


def test_one_rank_sharded_step_is_bit_equal_to_train_step():
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_torch.parallel import mesh as tmesh

    fused = FusedIslandMa(IslandNavigationExMa(**W.PPO_ENV_KW))
    config = ppo_fused.FusedPPOConfig(**W.PPO_KW)
    a = ppo_fused.init_train_state(fused, W.BATCH, seed=2, config=config,
                                   device="cpu")
    b = ppo_fused.init_train_state(fused, W.BATCH, seed=2, config=config,
                                   device="cpu")
    step = ppo_fused.make_train_step(fused, config, device="cpu")
    sharded, shard_state = ppo_fused.make_sharded_train_step(
        fused, tmesh.make_mesh(device="cpu"), config)
    b = shard_state(b)
    for _ in range(2):
        a, ma = step(a)
        b, mb = sharded(b)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        sa, sb = a.opt.state[a.params[k]], b.opt.state[b.params[k]]
        assert all(torch.equal(sa[n], sb[n]) for n in sa), k
    for k in a.S:
        assert torch.equal(a.S[k], b.S[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert b.update_idx == 2

"""One rank of the port's multi-process CPU tests (not collected by pytest).

    python tests/torch_multihost_worker.py <mode> <world> <rank> <store> <dir>

Joins a gloo process group of ``world`` ranks through the file store
``<store>`` (``parallel.multihost.initialize``, 60 s rendezvous timeout),
runs ``mode`` on one intra-op thread and writes this rank's results into
``<dir>``, which the tests read:

* ``scaleout`` (``tests/test_torch_parallel.py``): ``sharded_rollout`` of
  island_navigation (16 lanes, 20 steps), the rank's lanes through
  ``ShardedCsvSink``, and the lane-sharded plain fused rollouts of
  firemaker_ex_ma, island_navigation_ex_ma (per-lane layouts and per-lane
  linear policies) and aintelope_savanna (a layout pool);
* ``ppo`` (``tests/test_torch_parallel_ppo.py``): at world 2,
  ``make_sharded_train_step`` on island_navigation_ex_ma from the state in
  ``<dir>/start.npz`` with a checkpoint round trip, an uneven but valid
  composition (12 lanes, 3 minibatches) and A2C under a ``(1, 2)`` mesh;
  at world 4, the sharded step's refusals and A2C under a ``(2, 2)``
  mesh.

It imports neither jax nor the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ai_safety_gridworlds_torch.core import base, threefry  # noqa: E402
from ai_safety_gridworlds_torch.ops.fused_base import shard_statics  # noqa: E402
from ai_safety_gridworlds_torch.parallel import mesh as pmesh  # noqa: E402
from ai_safety_gridworlds_torch.parallel import multihost  # noqa: E402

GROUP_TIMEOUT_S = 180
BATCH = 16
ROLLOUT_STEPS = 20
FUSED_STEPS = 9
# The A2C step of __graft_entry__.dryrun_multichip at 4 devices (hidden 128,
# 4 unrolled steps), on 8 lanes.
A2C_BATCH, A2C_HIDDEN, A2C_STEPS = 8, 128, 4
PPO_KW = dict(n_steps=4, n_epochs=1, n_minibatches=2, hidden=8)
# island_navigation_ex_ma with per-lane layouts, so that the sharded step
# slices per-lane statics.
PPO_ENV_KW = dict(max_iterations=6, map_randomization_frequency=3)


def flat_state(tree, prefix=""):
    """A dataclass tree's tensors as numpy, by dotted field name."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flat_state(getattr(tree, f.name), prefix + f.name + "."))
        return out
    return {prefix[:-1]: tree.detach().cpu().numpy()}


def fused_engines():
    """(name, engine, packed state of BATCH lanes) of the three MA kernels'
    plain versions, each with per-lane statics where the engine has any."""
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.ops.fused_firemaker import FusedFiremaker
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna

    fm = FusedFiremaker(FiremakerExMa(max_iterations=6))
    im = FusedIslandMa(IslandNavigationExMa(max_iterations=6,
                                            map_randomization_frequency=3))
    sv = FusedSavanna(AIntelopeSavanna(max_iterations=6,
                                       map_randomization_frequency=1))
    S_fm = fm.init_packed(3, BATCH, "cpu")
    S_im = im.init_packed(3, BATCH, "cpu")
    rng = np.random.default_rng(5)
    A, F = im.amax - im.amin + 1, im.POLICY_FEATURES
    im.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                    rng.normal(size=(BATCH, A)).astype(np.float32), 0.2)
    S_sv = sv.init_packed(3, BATCH, "cpu", layout_pool=2)
    return (("firemaker", fm, S_fm), ("island", im, S_im),
            ("savanna", sv, S_sv))


def scaleout(world, rank, out):
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )

    mesh = multihost.make_global_mesh(device="cpu")
    assert mesh.shape == {"data": world, "model": 1}, mesh.shape
    eps, stats = pmesh.sharded_rollout(IslandNavigation(), mesh, 0,
                                       ROLLOUT_STEPS, BATCH)
    np.savez(os.path.join(out, f"rollout_rank{rank}.npz"), **flat_state(eps))
    g = multihost.global_batch_from_local(eps, mesh)
    sink = multihost.ShardedCsvSink(
        out, "rollout", ["episode_return", "hidden_return", "env_t"])
    sink.write(ROLLOUT_STEPS, {"episode_return": g.episode_return,
                               "hidden_return": g.hidden_return,
                               "env_t": g.env_state.t})
    sink.close()
    with open(os.path.join(out, f"global_rank{rank}.txt"), "w") as f:
        f.write(f"{int(stats['episodes'])};{float(stats['sum_final_return'])!r};"
                f"{float(stats['reward_sum'])!r}\n")

    lo, hi = mesh.lanes(BATCH)
    for name, fused, S in fused_engines():
        statics = shard_statics(fused.statics_on("cpu"), lo, hi)
        local = fused.rollout({k: v[:, lo:hi].contiguous() for k, v in S.items()},
                              FUSED_STEPS, statics=statics)
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
                 **{k: v.numpy() for k, v in local.items()})


def a2c_step(mesh, out, rank):
    """One A2C train_step under ``mesh`` from dryrun_multichip's keys; the
    rank's param shards, loss and the draws' least gap."""
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.learners import actor_critic as ac

    env = IslandNavigation()
    params = ac.init_params(1, 48, env.action_max - env.action_min + 1,
                            hidden=A2C_HIDDEN, device="cpu")
    local = ac.shard_params(params, mesh)
    lo, hi = mesh.lanes(A2C_BATCH)
    keys = threefry.split(threefry.PRNGKey(2, "cpu"), A2C_BATCH)
    ep = base.episode_reset(env, keys[lo:hi])
    gaps = []
    new, ep, loss = ac.train_step(local, env, ep, 3, n_steps=A2C_STEPS,
                                  draw_gaps=gaps, mesh=mesh)
    shape = "x".join(str(v) for v in mesh.shape.values())
    np.savez(os.path.join(out, f"a2c_{shape}_rank{rank}.npz"),
             loss=loss.numpy(), min_gap=float(torch.stack(gaps).min()),
             **{f: getattr(new, f).detach().numpy() for f in new._fields})


def ppo(world, rank, out):
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.learners import ppo_fused
    from ai_safety_gridworlds_torch.ops import interop
    from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
    from ai_safety_gridworlds_torch.utils import checkpoint

    fused = FusedIslandMa(IslandNavigationExMa(**PPO_ENV_KW))
    config = ppo_fused.FusedPPOConfig(**PPO_KW)
    if world == 4:
        mesh = pmesh.make_mesh(n_data=4, device="cpu")
        refusals = {}
        for label, batch, kw, tile in (
                ("batch", 6, {}, None), ("minibatch", 8, {"n_minibatches": 4}, None),
                ("tile", 16, {}, 48)):
            fused.init_packed(1, batch, "cpu")
            try:
                ppo_fused.make_sharded_train_step(
                    fused, mesh, ppo_fused.FusedPPOConfig(**{**PPO_KW, **kw}),
                    tile=tile)
                refusals[label] = None
            except ValueError as e:
                refusals[label] = str(e)
        state = ppo_fused.init_train_state(fused, BATCH, seed=1, config=config,
                                           device="cpu")
        train_step, shard_state = ppo_fused.make_sharded_train_step(
            fused, mesh, config)
        state = shard_state(state)
        fused.init_packed(2, BATCH, "cpu")
        try:
            train_step(state)
            refusals["statics"] = None
        except RuntimeError as e:
            refusals["statics"] = str(e)
        with open(os.path.join(out, f"refusals_rank{rank}.json"), "w") as f:
            json.dump(refusals, f)
        a2c_step(pmesh.make_mesh(n_data=2, n_model=2, device="cpu"), out, rank)
        return

    start = np.load(os.path.join(out, "start.npz"))
    fused.init_packed(int(start["seed"]), BATCH, "cpu")

    def group(prefix):
        return {k[len(prefix):]: start[k] for k in start.files
                if k.startswith(prefix)}

    def fresh():
        return interop.fused_ppo_state_from_numpy(
            fused, group("params."), group("mu."), group("nu."),
            start["count"], group("S."), config, "cpu")

    mesh = multihost.make_global_mesh(device="cpu")
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, config)
    state, metrics = train_step(shard_state(fresh()))
    np.savez(os.path.join(out, f"ppo_rank{rank}.npz"),
             **{"params." + k: v.detach().numpy()
                for k, v in state.params.items()},
             **{"S." + k: v.numpy() for k, v in state.S.items()},
             **{"metrics." + k: v.numpy() for k, v in metrics.items()})
    # A sharded checkpoint after one step; resuming from it is bit-equal to
    # running straight through.
    with checkpoint.CheckpointManager(os.path.join(out, "ckpt")) as mgr:
        mgr.save(1, state)
        template = shard_state(fresh())
        straight, _ = train_step(state)
        restored = mgr.restore(mgr.latest_step(), template)
    resumed, _ = train_step(restored)
    same = all(torch.equal(straight.params[k], resumed.params[k])
               for k in straight.params)
    same &= all(torch.equal(straight.S[k], resumed.S[k]) for k in straight.S)
    for p in straight.params:
        a = straight.opt.state[straight.params[p]]
        b = resumed.opt.state[resumed.params[p]]
        same &= all(torch.equal(a[k], b[k]) for k in a)
    with open(os.path.join(out, f"resume_rank{rank}.json"), "w") as f:
        json.dump({"bit_equal": bool(same),
                   "update_idx": resumed.update_idx}, f)
    # An uneven but valid composition: 12 lanes, 6 a rank, 3 minibatches.
    uneven = ppo_fused.FusedPPOConfig(**{**PPO_KW, "n_minibatches": 3})
    state = ppo_fused.init_train_state(fused, 12, seed=2, config=uneven,
                                       device="cpu")
    train_step, shard_state = ppo_fused.make_sharded_train_step(
        fused, mesh, uneven)
    state, metrics = train_step(shard_state(state))
    with open(os.path.join(out, f"uneven_rank{rank}.json"), "w") as f:
        json.dump({"update_idx": state.update_idx,
                   "lanes": state.S["t"].shape[1],
                   "finite": all(bool(torch.isfinite(v)) for v in
                                 metrics.values())}, f)
    a2c_step(pmesh.make_mesh(n_data=1, n_model=2, device="cpu"), out, rank)


def start_group(mode, world, out_dir):
    """Start ``world`` ranks of ``mode`` with their file store in
    ``out_dir``; returns the processes (:func:`wait_group` waits)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    store = os.path.join(out_dir, "store")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(world),
         str(rank), store, out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(world)]


def wait_group(procs, label, timeout=GROUP_TIMEOUT_S):
    """Wait for every rank; on expiry kill the group. Raises
    ``AssertionError`` unless every rank ended well."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise AssertionError(f"{label}: a rank timed out after {timeout} s")
        outs.append(out.decode())
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode or f"rank {rank} ok" not in out:
            raise AssertionError(f"{label}: rank {rank} failed:\n{out}")


def main():
    mode, world, rank, store, out = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                         timeout_s=60)
    try:
        {"scaleout": scaleout, "ppo": ppo}[mode](world, rank, out)
    finally:
        multihost.shutdown()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()

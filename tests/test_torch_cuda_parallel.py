"""The port's lane-sharded kernels and its one-rank NCCL mesh on the card.

Marked ``cuda``: each test skips without a CUDA device (checked inside the
fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda_parallel.py -q --noconftest

* K1, K6 and K8 run on two and four lane shards (``statics=`` from
  ``ops.fused_base.shard_statics``), with per-lane layouts and a per-lane
  linear policy where the engine has them, merged bit-equal to one
  unsharded launch;
* K3, K5, K7 and K9 run on two lane shards with the lane group (or lanes a
  warp) of the unsharded launch pinned, bit-equal to it in the state, the
  trajectory and the bootstrap value;
* on a one-rank NCCL process group (a file store under ``tmp_path``),
  ``make_sharded_train_step`` on island_navigation_ex_ma equals
  ``make_train_step`` bit for bit after two steps (params, Adam state,
  ``S``), and ``sharded_rollout`` runs with its collectives on the card.
"""

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_torch.envs.island_navigation import IslandNavigation
from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_torch.learners import ppo_fused
from ai_safety_gridworlds_torch.ops import fused_island_ma, fused_savanna
from ai_safety_gridworlds_torch.ops import fused_scalar, interop
from ai_safety_gridworlds_torch.ops.fused_base import shard_statics
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker,
    fused_firemaker_rollout,
)
from ai_safety_gridworlds_torch.ops.fused_island_ma import FusedIslandMa
from ai_safety_gridworlds_torch.ops.fused_savanna import FusedSavanna
from ai_safety_gridworlds_torch.ops.fused_scalar import FusedBoatRace

pytestmark = pytest.mark.cuda

BATCH = 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same(a, b):
    if not a.is_floating_point():
        a, b = a.to(torch.int64), b.to(torch.int64)
    return torch.equal(a, b)


def _lanes(S, lo, hi):
    return {k: v[:, lo:hi].contiguous() for k, v in S.items()}


def _engine(name, dev):
    """A fused engine and its packed state of BATCH lanes on ``dev``, with
    per-lane statics where the engine takes them."""
    rng = np.random.default_rng(1)
    if name == "firemaker":
        fused = FusedFiremaker(FiremakerExMa(max_iterations=40))
        S = fused.init_packed(0, BATCH, dev)
    elif name == "island":
        fused = FusedIslandMa(IslandNavigationExMa(
            map_randomization_frequency=1, max_iterations=20))
        S = fused.init_packed(0, BATCH, dev, layout_pool=3)
    else:
        fused = FusedSavanna(AIntelopeSavanna(map_randomization_frequency=1,
                                              max_iterations=40))
        S = fused.init_packed(0, BATCH, dev, layout_pool=3)
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    fused.set_policies(rng.normal(size=(BATCH, A, F)).astype(np.float32),
                       rng.normal(size=(BATCH, A)).astype(np.float32), 0.2)
    return fused, S


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["firemaker", "island", "savanna"])
def test_sharded_rollouts_bit_equal(dev, name, shards):
    fused, S = _engine(name, dev)
    ref = fused.rollout(S, 200)
    statics = fused.statics_on(dev)
    assert any(v.shape[1] == BATCH for v in statics.values())
    step = BATCH // shards
    parts = [fused.rollout(_lanes(S, lo, lo + step), 200,
                           statics=shard_statics(statics, lo, lo + step))
             for lo in range(0, BATCH, step)]
    for k in fused.STATE_FIELDS:
        assert _same(torch.cat([p[k] for p in parts], 1), ref[k]), k
    assert int(ref["stats_episodes"].sum()) > 0


@pytest.mark.parametrize("name", ["firemaker", "boat_race", "island",
                                  "savanna"])
def test_sharded_collections_bit_equal(dev, name, monkeypatch):
    if name == "firemaker":
        fused = FusedFiremaker(FiremakerExMa())
    elif name == "boat_race":
        fused = FusedBoatRace(BoatRace())
    elif name == "island":
        fused = FusedIslandMa(IslandNavigationExMa())
    else:
        fused = FusedSavanna(AIntelopeSavanna())
    S = fused.init_packed(0, BATCH, dev)
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    rng = np.random.default_rng(2)
    params = interop.params_from_numpy({
        "mlp_w1": rng.normal(size=(64, F)) / np.sqrt(F),
        "mlp_b1": rng.normal(size=(64, 1)) * 0.1,
        "mlp_w2": rng.normal(size=(A + 1, 64)) * 0.3,
        "mlp_b2": rng.normal(size=(A + 1, 1)) * 0.1,
    }, dev)
    # The unsharded launch's lane group (lanes a warp), pinned for both.
    if name == "island":
        monkeypatch.setattr(fused_island_ma, "_LANES_PER_GROUP",
                            fused_island_ma._lanes_per_group(fused, BATCH,
                                                             None, 64))
    elif name == "savanna":
        monkeypatch.setattr(fused_savanna, "_LANES_PER_GROUP",
                            fused_savanna._lanes_per_group(fused, BATCH,
                                                           None, 64))
    elif name == "boat_race":
        monkeypatch.setattr(fused_scalar, "_LANES_PER_WARP",
                            fused_scalar._lanes_per_warp(
                                BATCH, fused.DEFAULT_TILE, dev))
    S_ref, traj_ref, boot_ref = fused.rollout_collect(S, params, 64)
    statics = fused.statics_on(dev)
    half = BATCH // 2
    parts = [fused.rollout_collect(_lanes(S, lo, lo + half), params, 64,
                                   statics=shard_statics(statics, lo,
                                                         lo + half))
             for lo in (0, half)]
    for k in fused.STATE_FIELDS:
        assert _same(torch.cat([p[0][k] for p in parts], 1), S_ref[k]), k
    for k in traj_ref:
        assert _same(torch.cat([p[1][k] for p in parts], 2), traj_ref[k]), k
    assert _same(torch.cat([p[2] for p in parts], 1), boot_ref)


def test_one_rank_nccl_mesh(dev, tmp_path):
    import torch.distributed as dist

    from ai_safety_gridworlds_torch.parallel import mesh as pmesh
    from ai_safety_gridworlds_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         local_device_ids=[0], backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        mesh = multihost.make_global_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2,
                                          n_minibatches=4, hidden=32)
        fused = FusedIslandMa(IslandNavigationExMa())
        a = ppo_fused.init_train_state(fused, BATCH, seed=3, config=config)
        b = ppo_fused.init_train_state(fused, BATCH, seed=3, config=config)
        step = ppo_fused.make_train_step(fused, config)
        sharded, shard_state = ppo_fused.make_sharded_train_step(
            fused, mesh, config)
        b = shard_state(b)
        before = fused_island_ma.fused_island_ma_collect.launches
        for _ in range(2):
            a, ma = step(a)
            b, mb = sharded(b)
        assert fused_island_ma.fused_island_ma_collect.launches == before + 4
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
            sa, sb = a.opt.state[a.params[k]], b.opt.state[b.params[k]]
            assert all(torch.equal(sa[n], sb[n]) for n in sa), k
        for k in a.S:
            assert _same(a.S[k], b.S[k]), k
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        eps, stats = pmesh.sharded_rollout(IslandNavigation(), mesh, 0, 20,
                                           64)
        assert eps.last_step_type.device.type == "cuda"
        assert stats["reward_sum"].device.type == "cuda"
    finally:
        multihost.shutdown()


def test_k1_sharded_launch_counts_one_per_shard(dev):
    fused, S = _engine("firemaker", dev)
    before = fused_firemaker_rollout.launches
    statics = fused.statics_on(dev)
    for lo in (0, BATCH // 2):
        fused.rollout(_lanes(S, lo, lo + BATCH // 2), 10,
                      statics=shard_statics(statics, lo, lo + BATCH // 2))
    assert fused_firemaker_rollout.launches == before + 2

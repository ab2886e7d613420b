"""The port's scale-out (``parallel/mesh.py``, ``parallel/multihost.py`` and
the lane-sharded fused drivers) in real CPU processes on gloo, against the
JAX package.

One run of ``tests/torch_multihost_worker.py scaleout`` at each of one, two
and four ranks (a file store under ``tmp_path``; 60 s rendezvous, 180 s for
the whole group, which is killed on expiry) gives:

* ``sharded_rollout`` of island_navigation at two ranks against JAX's
  ``sharded_rollout`` on a two-device mesh: integer state and ``episodes``
  exact, float sums within 1e-5 relative (they sum the same per-step
  values in another order);
* the merged ``ShardedCsvSink`` files and the global stats byte-equal at
  one, two and four ranks, and the rows byte-equal to JAX's sink's for the
  same per-lane values;
* the plain K1, K6 and K8 rollouts run lane-sharded at two and four ranks,
  merged, bit-equal to the port's unsharded run (which the fused tests hold
  to JAX), as JAX's ``tests/test_sharded_fused.py`` checks its kernels.

The mesh's refusals run in this process (one rank, no process group).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.parallel import mesh as tmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_multihost_worker as W  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)
BATCH, ROLLOUT_STEPS, FUSED_STEPS = W.BATCH, W.ROLLOUT_STEPS, W.FUSED_STEPS
COLUMNS = "step;lane;episode_return;hidden_return;env_t"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: output directory}`` of one scaleout run at each world."""
    dirs, groups = {}, {}
    for world in WORLDS:
        dirs[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        groups[world] = W.start_group("scaleout", world, dirs[world])
    for world in WORLDS:
        W.wait_group(groups[world], f"scaleout world {world}")
    return dirs


def merged_npz(out_dir, stem, world):
    """Each rank's saved lanes joined in rank order (lanes on the last
    axis)."""
    parts = [np.load(os.path.join(out_dir, f"{stem}_rank{r}.npz"))
             for r in range(world)]
    axis = 0 if stem == "rollout" else 1
    return {k: np.concatenate([p[k] for p in parts], axis=axis)
            for k in parts[0].files}


def merged_rows(out_dir, world):
    rows = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rollout_host{r}.csv")) as f:
            lines = f.read().splitlines()
        assert lines[0] == COLUMNS
        rows += lines[1:]
    return rows


def test_sharded_rollout_matches_jax(runs):
    from ai_safety_gridworlds_tpu.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_tpu.parallel import mesh as jmesh

    eps, stats = jmesh.sharded_rollout(
        IslandNavigation(), jmesh.make_mesh(n_data=2), jax.random.PRNGKey(0),
        ROLLOUT_STEPS, BATCH)
    got = merged_npz(runs[2], "rollout", 2)
    want = {
        "last_step_type": eps.last_step_type,
        "episode_return": eps.episode_return,
        "hidden_return": eps.hidden_return,
        "env_state.t": eps.env_state.t,
        "env_state.key": eps.env_state.key,
        "env_state.pos": eps.env_state.pos,
        "env_state.safety": eps.env_state.safety,
    }
    for k, v in want.items():
        v = np.asarray(v)
        if k == "env_state.key":  # JAX's uint32 words, the port's int64
            v = v.astype(np.int64)
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with open(os.path.join(runs[2], "global_rank0.txt")) as f:
        episodes, final_return, reward = f.read().strip().split(";")
    assert int(episodes) == int(stats["episodes"])
    np.testing.assert_allclose(float(final_return),
                               float(stats["sum_final_return"]), rtol=1e-5)
    np.testing.assert_allclose(float(reward), float(stats["reward_sum"]),
                               rtol=1e-5)
    assert float(reward) != 0.0


def test_merged_sinks_and_stats_are_world_size_invariant(runs):
    base_rows = merged_rows(runs[1], 1)
    with open(os.path.join(runs[1], "global_rank0.txt")) as f:
        base_global = f.read()
    for world in WORLDS:
        rows = merged_rows(runs[world], world)
        assert rows == base_rows, f"world {world}: merged CSV diverged"
        lanes = [int(r.split(";")[1]) for r in rows]
        assert lanes == list(range(BATCH))
        # Each rank wrote its own contiguous block of lanes.
        local = BATCH // world
        for r in range(world):
            with open(os.path.join(runs[world], f"rollout_host{r}.csv")) as f:
                own = [int(x.split(";")[1]) for x in f.read().splitlines()[1:]]
            assert own == list(range(r * local, (r + 1) * local))
        for r in range(world):
            with open(os.path.join(runs[world], f"global_rank{r}.txt")) as f:
                assert f.read() == base_global, (world, r)


def test_sink_rows_are_byte_equal_to_jax_sink(runs, tmp_path):
    from ai_safety_gridworlds_tpu.parallel.multihost import ShardedCsvSink

    got = merged_npz(runs[1], "rollout", 1)
    sink = ShardedCsvSink(str(tmp_path), "rollout",
                          ["episode_return", "hidden_return", "env_t"])
    sink.write(ROLLOUT_STEPS, {
        "episode_return": jnp.asarray(got["episode_return"]),
        "hidden_return": jnp.asarray(got["hidden_return"]),
        "env_t": jnp.asarray(got["env_state.t"]),
    })
    sink.close()
    with open(tmp_path / "rollout_host0.csv") as f:
        jax_rows = f.read().splitlines()
    assert jax_rows[0] == COLUMNS
    assert merged_rows(runs[1], 1) == jax_rows[1:]


def test_sink_formats_fractions_as_jax_sink(tmp_path):
    """Fractional, tiny, negative and integral float32 and int32 values,
    and the refusal of columns with differing lane shardings."""
    from ai_safety_gridworlds_tpu.parallel.multihost import (
        ShardedCsvSink as JaxSink,
    )

    from ai_safety_gridworlds_torch.parallel import multihost

    vals = np.array([0.1, 1 / 3, 2.0, -1.5e-7, 12345.678, -0.0], np.float32)
    ints = np.arange(-3, 3, dtype=np.int32)
    rows = {}
    for label, sink_cls, wrap in (("jax", JaxSink, jnp.asarray),
                                  ("port", multihost.ShardedCsvSink,
                                   torch.from_numpy)):
        sink = sink_cls(str(tmp_path / label), "s", ["f", "i"])
        sink.write(3, {"f": wrap(vals), "i": wrap(ints)})
        sink.close()
        with open(tmp_path / label / "s_host0.csv") as f:
            rows[label] = f.read()
    assert rows["port"] == rows["jax"]
    mesh = tmesh.Mesh(torch.arange(2).view(2, 1), torch.device("cpu"))
    sink = multihost.ShardedCsvSink(str(tmp_path / "mix"), "s", ["f", "i"])
    with pytest.raises(ValueError, match="differing lane shardings"):
        sink.write(0, {
            "f": multihost.global_array_from_local(torch.from_numpy(vals[:3]),
                                                   mesh, ("data",)),
            "i": torch.from_numpy(ints),
        })
    sink.close()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["firemaker", "island", "savanna"])
def test_sharded_fused_rollouts_bit_equal(runs, name, world):
    fused, S = {n: (f, S) for n, f, S in W.fused_engines()}[name]
    ref = fused.rollout(S, FUSED_STEPS)
    got = merged_npz(runs[world], name, world)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert int(ref["stats_episodes"].sum()) > 0
    if name != "firemaker":
        lanes = {v.shape[1] for v in fused.statics_on("cpu").values()}
        assert BATCH in lanes, "the check needs per-lane statics"


def test_make_mesh_refusals_and_one_rank_mesh():
    avail = 1
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(n_data=avail + 1, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(n_data=avail, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="n_model"):
        tmesh.make_mesh(n_model=0, device="cpu")
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device_mesh is None and mesh.lanes(8) == (0, 8)
    x = torch.arange(4.0)
    assert torch.equal(tmesh.all_reduce(x.clone(), mesh, mean=True), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()  # device="cuda" by default


def test_sharded_rollout_refuses_nondivisible_batch():
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )

    mesh = tmesh.Mesh(torch.arange(4).view(4, 1), torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        tmesh.sharded_rollout(IslandNavigation(), mesh, 0, n_steps=2,
                              batch_size=6)


def test_shard_episode_batch_takes_the_ranks_lanes():
    from ai_safety_gridworlds_torch.core import base, threefry
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )

    env = IslandNavigation()
    eps = base.episode_reset(env, threefry.split(threefry.PRNGKey(0, "cpu"),
                                                 8))
    # Rank 0 of a two-rank data axis (no process group: the lanes only).
    mesh = tmesh.Mesh(torch.arange(2).view(2, 1), torch.device("cpu"))
    local = tmesh.shard_episode_batch(eps, mesh)
    from ai_safety_gridworlds_torch.parallel import multihost

    g = multihost.global_batch_from_local(local, mesh)
    assert g.env_state.pos.global_shape == (8,) + tuple(eps.env_state.pos.shape[1:])
    assert list(g.episode_return.indices()) == [0, 1, 2, 3]
    assert torch.equal(local.env_state.pos, eps.env_state.pos[:4])
    assert torch.equal(local.last_step_type, eps.last_step_type[:4])
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_episode_batch(
            base.episode_reset(env, threefry.split(
                threefry.PRNGKey(0, "cpu"), 5)), mesh)

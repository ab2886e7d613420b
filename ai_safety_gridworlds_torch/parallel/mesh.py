"""Scale-out of batched rollouts over ranks.

Port of ``ai_safety_gridworlds_tpu/parallel/mesh.py``. JAX's
``jax.sharding.Mesh`` becomes a ``torch.distributed`` process group, one rank
a device, with a ``torch.distributed.device_mesh.DeviceMesh`` over it whose
dims are named ``("data", "model")``:

* **data parallelism**: the env batch's lanes split over ``"data"``; rank
  ``i`` of the axis holds lanes ``[i * B / n, (i + 1) * B / n)``
  (:meth:`Mesh.lanes`);
* **metric aggregation**: statistics cross the ranks by collectives over
  the axis's group (:func:`all_reduce`, :func:`all_gather_lanes`), summed
  in a fixed global-lane order where the result must not depend on the
  world size;
* **model parallelism**: learner parameters may be split over ``"model"``
  (``learners/actor_critic.py::param_shardings``).

The backend is NCCL on the card and gloo on the CPU (and in the tests); the
caller names it when it brings the group up (``parallel/multihost.py``).
A CUDA tensor under gloo is reduced through a host copy.

JAX's ``shard_map`` has no PyTorch counterpart: a program is not traced
once and partitioned, each rank runs its own eager code. What stands in its
place is the rank-local lane range (:meth:`Mesh.lanes`) and the lane-sharded
fused drivers (``FusedMaBase.rollout`` / ``rollout_collect`` with
``statics=`` from ``ops.fused_base.shard_statics``), whose kernels launch on
the rank's lanes alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ai_safety_gridworlds_torch.core import base as core_base
from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.ops import resolve_device

AXES = ("data", "model")


class Mesh:
    """A ``("data", "model")`` mesh of ranks and this rank's place in it.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``;
    ``device`` is the torch device this rank computes on; ``device_mesh``
    the ``DeviceMesh`` over the process group (``None`` for a one-rank mesh
    with no process group). Build it with :func:`make_mesh`."""

    axis_names = AXES

    def __init__(self, ranks: torch.Tensor, device: torch.device,
                 device_mesh=None):
        self.ranks = ranks  # [n_data, n_model] global ranks
        self.device = device
        self.device_mesh = device_mesh
        self.shape = dict(zip(AXES, ranks.shape))
        rank = dist.get_rank() if device_mesh is not None else 0
        where = (ranks == rank).nonzero()
        self.coordinate = ({a: int(i) for a, i in zip(AXES, where[0])}
                           if len(where) else None)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.coordinate is None:
            raise ValueError("this rank is not in the mesh")
        return self.coordinate[axis]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (``None`` for a
        one-rank mesh with no process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def lanes(self, batch: int, axis: str = "data") -> tuple:
        """``(lo, hi)``: this rank's lanes of a ``batch`` split over
        ``axis``; raises ``ValueError`` when the axis does not divide it."""
        n = self.shape[axis]
        if batch % n:
            raise ValueError(
                f"batch_size {batch} must divide over {axis} axis {n}"
            )
        lo = self.index(axis) * (batch // n)
        return lo, lo + batch // n

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, device={self.device}, "
                f"coordinate={self.coordinate})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh over the ranks ``devices`` (by default
    every rank of the process group; one rank, with no rendezvous, when no
    group is up), this rank computing on ``device`` (``"cuda"``: the current
    card; raises without one). Every rank of the group calls it with the
    same arguments (the sub-groups are made collectively)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    devices = list(range(world)) if devices is None else list(devices)
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        if len(devices) < n_model:
            raise ValueError(
                f"n_model {n_model} exceeds the {len(devices)} available "
                "devices"
            )
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices "
            f"but only {len(devices)} are available"
        )
    if any(not 0 <= r < world for r in devices):
        raise ValueError(f"devices {devices} are not ranks of the "
                         f"{world}-rank world")
    ranks = torch.tensor(devices[: n_data * n_model]).view(n_data, n_model)
    if not grouped:
        return Mesh(ranks, dev)
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(ranks, dev,
                DeviceMesh(device_type, ranks, mesh_dim_names=AXES))


def all_reduce(tensor: torch.Tensor, mesh: Mesh, axis: str = "data",
               mean: bool = False) -> torch.Tensor:
    """Sum (or, with ``mean``, average) ``tensor`` in place over this
    rank's ``axis`` group; returns it. A CUDA tensor under gloo goes
    through the host. On a one-rank mesh with no group only ``mean``'s
    division by 1 runs."""
    group = mesh.group(axis)
    if group is not None:
        if tensor.is_cuda and dist.get_backend(group) != "nccl":
            host = tensor.cpu()
            dist.all_reduce(host, group=group)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor, group=group)
    if mean:
        tensor /= mesh.shape[axis]
    return tensor


def all_gather_lanes(tensor: torch.Tensor, mesh: Mesh, axis: str = "data",
                     dim: int = 0) -> torch.Tensor:
    """The ``axis`` group's shards of ``tensor`` (each rank's lanes along
    ``dim``) joined in global-lane order, on every rank."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    src = tensor.contiguous()
    if src.is_cuda and dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(tensor.device)


def shard_episode_batch(ep_batch, mesh: Mesh, axis: str = "data"):
    """This rank's lanes of a global batched ``EpisodeState`` (every field
    split along its leading axis), on the mesh's device."""
    batch = ep_batch.last_step_type.shape[0]
    lo, hi = mesh.lanes(batch, axis)
    return core_base.tree_map(
        lambda x: x[lo:hi].contiguous().to(mesh.device), ep_batch)


def sharded_rollout(env, mesh: Mesh, key, n_steps: int, batch_size: int):
    """A batched auto-resetting rollout with the env batch split over the
    mesh's ``"data"`` axis, on the generic path (``core/base.py``) on the
    mesh's device.

    Every rank derives the global keys and each step's actions from ``key``
    with ``core/threefry.py``, as the JAX package does, and steps only its
    own lanes. Returns ``(ep_batch, stats)``: this rank's final lanes, and
    on every rank the global ``episodes`` (int32), ``sum_final_return`` and
    ``reward_sum`` (float32). Each lane's sums over the steps are gathered
    and summed over the lanes in global-lane order, so the world size
    changes no bit of them."""
    dev = mesh.device
    lo, hi = mesh.lanes(batch_size)
    key = key.to(dev) if isinstance(key, torch.Tensor) else threefry.PRNGKey(
        key, dev)
    init_keys = threefry.split(key, batch_size + 1)
    eps = core_base.episode_reset(env, init_keys[1 + lo:1 + hi])
    step_keys = threefry.split(init_keys[0], n_steps)
    lanes = hi - lo
    episodes = torch.zeros(lanes, dtype=torch.int32, device=dev)
    final_return = torch.zeros(lanes, dtype=torch.float32, device=dev)
    reward = torch.zeros(lanes, dtype=torch.float32, device=dev)
    for s in range(n_steps):
        actions = threefry.randint(step_keys[s], (batch_size,),
                                   env.action_min, env.action_max + 1)
        eps, outs = core_base.episode_step(env, eps, actions[lo:hi])
        done = outs.step.game_over
        fr = outs.final_return.reshape(lanes, -1).sum(dim=1)
        episodes += done.to(torch.int32)
        final_return += torch.where(done, fr, 0.0)
        reward += outs.step.reward.reshape(lanes, -1).sum(dim=1)
    per_lane = all_gather_lanes(
        torch.stack([episodes.to(torch.float32), final_return, reward]),
        mesh, dim=1)
    stats = {
        "episodes": per_lane[0].to(torch.int32).sum(dtype=torch.int32),
        "sum_final_return": per_lane[1].sum(),
        "reward_sum": per_lane[2].sum(),
    }
    return eps, stats

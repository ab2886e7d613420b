"""Multi-process scale-out: the process group, global meshes and
rank-sharded sinks.

Port of ``ai_safety_gridworlds_tpu/parallel/multihost.py``:

* :func:`initialize` brings up ``torch.distributed`` (NCCL on the card by
  default; ``backend="gloo"`` for CPU processes, which the caller names:
  it never stands in for a failed NCCL), with a rendezvous timeout;
* :func:`make_global_mesh`, a ``("data", "model")`` mesh over every rank;
* :func:`global_array_from_local` / :func:`global_batch_from_local` hold a
  rank's local shard with its global offset (:class:`ShardedArray`): each
  rank initializes only its own lanes;
* :class:`ShardedCsvSink`, each rank writing the rows of its own lanes, keyed
  by global lane index, in the semicolon and decimal-normalized format of the
  env CSV logger (``mo/safety_game_mo.py``), so the ranks' files merge into
  the one-rank log whatever the world size.

``tests/test_torch_parallel.py`` runs it in one, two and four CPU processes
on gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
import numbers
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ai_safety_gridworlds_torch.core import base as core_base
from ai_safety_gridworlds_torch.ops import resolve_device
from ai_safety_gridworlds_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    timeout_s: float = 60.0,
) -> None:
    """Join the ``num_processes``-rank process group as rank
    ``process_id``.

    ``coordinator_address`` is where the ranks meet: ``host:port`` (rank 0
    listens there) or any ``torch.distributed`` init URL (``tcp://...``,
    ``file:///path`` for a file store). ``backend`` is ``"nccl"`` by default,
    on the card ``local_device_ids[0]`` (else the current device), and
    raises without one; pass ``"gloo"`` for CPU processes. A rendezvous
    that does not complete within ``timeout_s`` seconds raises."""
    backend = "nccl" if backend is None else backend
    if backend == "nccl":
        dev = resolve_device("cuda")
        if local_device_ids:
            dev = torch.device("cuda", int(local_device_ids[0]))
            torch.cuda.set_device(dev)
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id: nothing here infers them")
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group (``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(n_model: int = 1, device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh over every rank of the group; every
    rank calls it with the same arguments."""
    return make_mesh(n_model=n_model, device=device)


@dataclasses.dataclass
class ShardedArray:
    """A rank's shard of a global array: ``local`` holds the global indices
    ``offset .. offset + local.shape[dim] - 1`` of dimension ``dim`` of an
    array of ``global_shape``."""

    local: torch.Tensor
    dim: int
    offset: int
    global_shape: tuple

    def indices(self) -> range:
        """The global indices along ``dim`` this rank holds."""
        return range(self.offset, self.offset + self.local.shape[self.dim])


def global_array_from_local(local, mesh: Mesh, spec) -> ShardedArray:
    """This rank's ``local`` shard of a global array split as ``spec`` (a
    tuple naming the mesh axis that splits each dimension, or None; one
    axis at most, the JAX package's ``PartitionSpec``) over ``mesh``, on
    the mesh's device."""
    local = torch.as_tensor(local).to(mesh.device)
    spec = tuple(spec) + (None,) * (local.dim() - len(tuple(spec)))
    split = [(d, a) for d, a in enumerate(spec) if a is not None]
    if len(split) > 1:
        raise ValueError(f"spec {spec} splits more than one dimension")
    if not split:
        return ShardedArray(local, 0, 0, tuple(local.shape))
    dim, axis = split[0]
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * mesh.shape[axis]
    return ShardedArray(local, dim, mesh.index(axis) * n, tuple(shape))


def global_batch_from_local(local_pytree, mesh: Mesh, axis: str = "data"):
    """:func:`global_array_from_local` over every leaf of ``local_pytree``
    with the leading axis split over ``axis`` (the env-batch layout of
    ``parallel.mesh.sharded_rollout``)."""
    return core_base.tree_map(
        lambda x: global_array_from_local(x, mesh, (axis,)), local_pytree)


class ShardedCsvSink:
    """Per-rank CSV sink of per-lane values.

    Each rank opens ``<log_dir>/<stem>_host<rank>.csv``, and :meth:`write`
    appends one row per lane it holds::

        step; lane; <column values...>

    where ``lane`` is the global batch index, so concatenating every rank's
    file gives the whole log with no duplicates."""

    def __init__(self, log_dir: str, stem: str, columns: Sequence[str]):
        self.columns = list(columns)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{stem}_host{process_index()}.csv")
        self._f = open(self.path, "w")
        self._f.write(";".join(["step", "lane"] + self.columns) + "\n")
        self._f.flush()
        # prec=10, half-up: the env CSV logger's normalization
        # (``mo/safety_game_mo.py``).
        self._decimal = decimal.Context(
            prec=10, rounding=decimal.ROUND_HALF_UP, capitals=0
        )

    def _fmt(self, value) -> str:
        if isinstance(value, numbers.Number):
            d = self._decimal.create_decimal_from_float(float(value))
            integral = d.to_integral()
            return str(integral if d == integral else d.normalize())
        return str(value)

    def write(self, step: int, values: dict) -> None:
        """Append rows for the lanes this rank holds.

        ``values`` maps column name to a lane-sharded 1-D
        :class:`ShardedArray` (the per-lane metric) or a tensor or array of
        every lane. Nothing crosses ranks."""
        cols, lane_sets = {}, {}
        for name in self.columns:
            arr = values[name]
            if isinstance(arr, ShardedArray):
                data, lanes = arr.local, arr.indices()
            else:
                data, lanes = arr, range(arr.shape[0])
            if isinstance(data, torch.Tensor):
                data = data.detach().cpu().numpy()
            cols[name] = dict(zip(lanes, np.asarray(data).reshape(-1)))
            lane_sets[name] = frozenset(lanes)
        # All columns must agree on which lanes this rank holds: a mix of
        # lane-sharded and whole columns would write duplicate or missing
        # rows across ranks.
        if len(set(lane_sets.values())) > 1:
            detail = {k: sorted(v)[:4] for k, v in lane_sets.items()}
            raise ValueError(
                "ShardedCsvSink columns have differing lane shardings: "
                f"{detail} — shard every logged column over the batch "
                "axis (replicated stats belong in a rank-0-only log)"
            )
        lanes = sorted(next(iter(lane_sets.values()))) if lane_sets else []
        for lane in lanes:
            row = [str(step), str(lane)] + [
                self._fmt(cols[name][lane]) for name in self.columns
            ]
            self._f.write(";".join(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

"""Checkpoint and resume of training state and environment batches.

Port of ``ai_safety_gridworlds_tpu/utils/checkpoint.py``, with
``torch.save`` and ``torch.load(weights_only=True)`` in place of orbax. A
state is a tree of dataclasses (``FusedPPOState``, ``PPOState``, the
episode batches), NamedTuples (``ACParams``), dicts, lists and tuples whose
leaves are tensors, Python numbers and ``torch.optim`` optimizers. An
optimizer is saved as its per-parameter state (Adam's ``step``,
``exp_avg`` and ``exp_avg_sq``) and restored as a new optimizer of the
template's class and settings over the restored parameter tensors, so that
its moments and count follow the params. Resume is bit-exact
(``tests/test_torch_checkpoint.py``).

A restored tree takes its structure, dtypes and devices from a template (a
state of the same configuration, such as a fresh ``init_train_state``).
Under ``torch.distributed`` every rank saves and restores its own tree (a
sharded state: its lanes, on its device) as ``shard<rank>.pt`` of the one
checkpoint directory. A save writes into ``<path>.tmp`` and renames it to
``path`` once every rank has written, so a directory named ``path`` holds a
whole checkpoint; a save refuses a ``path`` that exists.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any

import torch
import torch.distributed as dist

_FORMAT = 1


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier():
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _flatten(tree, leaves: list, opts: list) -> None:
    """The tensor and number leaves of ``tree`` in a fixed order, and its
    optimizers (saved after every leaf, so their params are known)."""
    if isinstance(tree, torch.optim.Optimizer):
        opts.append(tree)
    elif isinstance(tree, torch.Tensor):
        leaves.append(tree)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), leaves, opts)
    elif isinstance(tree, dict):
        for k in tree:
            _flatten(tree[k], leaves, opts)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, leaves, opts)
    elif tree is None or isinstance(tree, (bool, int, float, str)):
        leaves.append(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _opt_record(opt, index: dict) -> dict:
    """An optimizer's per-parameter state, each parameter named by its
    position among the tree's leaves."""
    params, states = [], []
    for group in opt.param_groups:
        for p in group["params"]:
            if id(p) not in index:
                raise ValueError("an optimizer's parameter is not a leaf of "
                                 "the checkpointed tree")
            params.append(index[id(p)])
            states.append({k: v.detach().cpu() if torch.is_tensor(v) else v
                           for k, v in opt.state.get(p, {}).items()})
    return {"params": params, "state": states}


def _record(pytree) -> dict:
    leaves, opts = [], []
    _flatten(pytree, leaves, opts)
    index = {id(x): i for i, x in enumerate(leaves) if torch.is_tensor(x)}
    return {
        "format": _FORMAT,
        "world_size": _rank_world()[1],
        "leaves": [x.detach().cpu() if torch.is_tensor(x) else x
                   for x in leaves],
        "optimizers": [_opt_record(o, index) for o in opts],
    }


def save_pytree(path: str, pytree: Any) -> None:
    """Write ``pytree`` (params, optimizer, episode batch or packed state,
    keys, counters) to the new directory ``path``; every rank of a process
    group calls it, each with its own tree."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"{path} already holds a checkpoint")
    rank, _ = _rank_world()
    tmp = path + ".tmp"
    if rank == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)  # a save that never finished
    _barrier()
    os.makedirs(tmp, exist_ok=True)
    torch.save(_record(pytree), os.path.join(tmp, f"shard{rank}.pt"))
    _barrier()
    if rank == 0:
        os.replace(tmp, path)
    _barrier()


def _restore(template, leaves: list, pos: list, restored: dict):
    """``template``'s structure with the saved ``leaves`` in its tensor and
    number places; each tensor on the template's device and dtype, a leaf
    that requires grad again as such. ``restored`` maps each template
    tensor's id to its restored tensor."""
    if isinstance(template, torch.optim.Optimizer):
        return template  # rebuilt by restore_pytree once every leaf is back
    if isinstance(template, torch.Tensor):
        saved = leaves[pos[0]]
        pos[0] += 1
        if not torch.is_tensor(saved) or saved.shape != template.shape:
            raise ValueError(
                f"leaf {pos[0] - 1}: saved "
                f"{getattr(saved, 'shape', type(saved).__name__)}, template "
                f"{tuple(template.shape)}"
            )
        out = saved.to(device=template.device, dtype=template.dtype)
        if template.requires_grad:
            out = out.detach().requires_grad_()
        restored[id(template)] = out
        return out
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _restore(getattr(template, f.name), leaves, pos, restored)
            for f in dataclasses.fields(template)
        })
    if isinstance(template, dict):
        return {k: _restore(v, leaves, pos, restored)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_restore(x, leaves, pos, restored)
                                for x in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(x, leaves, pos, restored)
                              for x in template)
    saved = leaves[pos[0]]
    pos[0] += 1
    return saved


def _rebuild_optimizers(template, out, record, restored: dict):
    """Swap each optimizer of ``out`` (still the template's) for a new one
    of its class and settings over the restored params, with the saved
    state."""
    t_leaves, t_opts = [], []
    _flatten(template, t_leaves, t_opts)
    if len(t_opts) != len(record["optimizers"]):
        raise ValueError(
            f"the template has {len(t_opts)} optimizers, the checkpoint "
            f"{len(record['optimizers'])}"
        )
    new_opts = []
    for opt, rec in zip(t_opts, record["optimizers"]):
        groups = []
        for group in opt.param_groups:
            params = [restored[id(p)] for p in group["params"]]
            groups.append({**{n: v for n, v in group.items()
                              if n != "params"}, "params": params})
        new = type(opt)(groups)
        flat = [p for g in groups for p in g["params"]]
        if len(flat) != len(rec["state"]):
            raise ValueError("the template's optimizer has another number "
                             "of parameters than the saved one")
        for p, st in zip(flat, rec["state"]):
            if st:
                new.state[p] = {
                    n: (v.to(p.device) if torch.is_tensor(v) and v.dim() > 0
                        else v)
                    for n, v in st.items()
                }
        new_opts.append(new)
    swap = {id(o): n for o, n in zip(t_opts, new_opts)}

    def put(tree):
        if isinstance(tree, torch.optim.Optimizer):
            return swap[id(tree)]
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{
                f.name: put(getattr(tree, f.name))
                for f in dataclasses.fields(tree)
            })
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(put(x) for x in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(put(x) for x in tree)
        return tree

    return put(out) if new_opts else out


def restore_pytree(path: str, template: Any) -> Any:
    """Restore a tree written by :func:`save_pytree` in the structure,
    dtypes and devices of ``template`` (this rank's shard of it under a
    process group); the template is left as it was."""
    rank, world = _rank_world()
    record = torch.load(os.path.join(os.path.abspath(path),
                                     f"shard{rank}.pt"),
                        map_location="cpu", weights_only=True)
    if record.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this format")
    if record["world_size"] != world:
        raise ValueError(
            f"{path} was saved by {record['world_size']} ranks, restored by "
            f"{world}"
        )
    restored, pos = {}, [0]
    out = _restore(template, record["leaves"], pos, restored)
    if pos[0] != len(record["leaves"]):
        raise ValueError(
            f"the template has {pos[0]} leaves, the checkpoint "
            f"{len(record['leaves'])}"
        )
    return _rebuild_optimizers(template, out, record, restored)


class CheckpointManager:
    """A directory of stepped checkpoints with retention and resume::

        mgr = CheckpointManager(dir, max_to_keep=3, save_interval_steps=10)
        mgr.save(step, train_state)           # no-op off the interval
        step = mgr.latest_step()              # None if empty
        state = mgr.restore(step, template)   # bit-exact resume

    Each step is a :func:`save_pytree` directory named by its number; the
    oldest beyond ``max_to_keep`` are deleted after each save."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        """The steps with a whole checkpoint, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def save(self, step: int, pytree: Any) -> bool:
        """Save ``pytree`` as ``step`` when ``step`` is a multiple of
        ``save_interval_steps``; returns whether it saved."""
        if step % self.save_interval_steps:
            return False
        save_pytree(os.path.join(self.directory, str(step)), pytree)
        if _rank_world()[0] == 0 and self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        _barrier()
        return True

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        return restore_pytree(os.path.join(self.directory, str(step)),
                              template)

    def close(self):
        _barrier()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

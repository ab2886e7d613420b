"""A compact advantage actor-critic learner over the generic batched chains.

Port of ``ai_safety_gridworlds_tpu/learners/actor_critic.py``: the MLP
(``init_params``, ``forward``), the A2C unroll and loss
(``unroll_and_loss``) and one SGD step (``train_step``), drawn from JAX's
threefry key chain (``core/threefry.py``) so that the same key gives the
same params and the same actions. ``params_from_jax`` carries a JAX
``ACParams`` (as numpy) across.

Under a ``("data", "model")`` mesh (``parallel.mesh.make_mesh``) the
episode batch splits over ``"data"`` and the hidden dimension over
``"model"`` (:func:`param_shardings`, :func:`shard_params`): each rank holds
its columns of ``w1``, its part of ``b1`` and its rows of ``w2``; the
second layer's partial products are summed over the ``"model"`` group (a
forward all-reduce whose backward passes the cotangent on, since every
rank of the group computes the same loss from the sum), and the gradients
are averaged over ``"data"``. Each rank draws its lanes' actions from the
global batch's draws, so the step is the one-process step up to the order
of float32 sums.

Precision follows the JAX forward: the observation and ``w1``, then the
hidden layer and ``w2``, are rounded to bfloat16 and multiplied with
float32 accumulation; the policy and value heads are float32. Here the
rounded operands are cast back to float32 before the product, so that
``torch.matmul`` accumulates in float32 (a product of two bfloat16 values is
exact in float32, and in TF32). Under autograd the casts put JAX's bfloat16
rounding on the same cotangents: the gradients of ``w1`` and ``w2`` and the
one that flows back into the first hidden layer.

The params are leaf tensors that require grad; the entry points run on the
params' device, ``"cuda"`` unless the caller asks for ``"cpu"``
(``init_params``' ``device``), and raise for a card that is not there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import base, threefry
from ai_safety_gridworlds_torch.ops import resolve_device

_F32 = torch.float32


class ACParams(NamedTuple):
    w1: torch.Tensor  # [obs_dim, hidden]
    b1: torch.Tensor  # [hidden]
    w2: torch.Tensor  # [hidden, hidden]
    b2: torch.Tensor  # [hidden]
    w_pi: torch.Tensor  # [hidden, n_actions]
    b_pi: torch.Tensor  # [n_actions]
    w_v: torch.Tensor  # [hidden, 1]
    b_v: torch.Tensor  # [1]


def as_key(key, device) -> torch.Tensor:
    """A threefry key on ``device``: a ``[2]`` tensor, or an int seed for
    ``PRNGKey``."""
    dev = resolve_device(device)
    if isinstance(key, torch.Tensor):
        return key.to(dev)
    return threefry.PRNGKey(key, dev)


def _leaves(tensors) -> ACParams:
    return ACParams(*(t.detach().to(_F32).contiguous().requires_grad_()
                      for t in tensors))


def init_params(key, obs_dim: int, n_actions: int, hidden: int = 256,
                device="cuda") -> ACParams:
    """JAX's ``init_params`` from the same key: normal weights scaled by
    1/sqrt(fan_in) (the policy head by 0.01), zero biases."""
    k = threefry.split(as_key(key, device), 4)

    def scale(fan_in):
        return float(np.float32(1.0 / np.sqrt(fan_in)))

    dev = k.device
    return _leaves((
        threefry.normal(k[0], (obs_dim, hidden)) * scale(obs_dim),
        torch.zeros(hidden, device=dev),
        threefry.normal(k[1], (hidden, hidden)) * scale(hidden),
        torch.zeros(hidden, device=dev),
        threefry.normal(k[2], (hidden, n_actions)) * float(np.float32(0.01)),
        torch.zeros(n_actions, device=dev),
        threefry.normal(k[3], (hidden, 1)) * scale(hidden),
        torch.zeros(1, device=dev),
    ))


def param_shardings(mesh) -> ACParams:
    """Tensor-parallel layout: the hidden dimension split over the
    ``"model"`` axis. Each field is a tuple naming, per dimension, the mesh
    axis that splits it (the JAX package's ``PartitionSpec``)."""
    del mesh
    return ACParams(
        w1=(None, "model"), b1=("model",), w2=("model", None), b2=(),
        w_pi=(None,), b_pi=(), w_v=(None,), b_v=(),
    )


def shard_params(params: ACParams, mesh) -> ACParams:
    """This rank's leaf tensors of ``params`` (the whole params, the same on
    every rank) under :func:`param_shardings`, on the mesh's device."""
    out = []
    for p, spec in zip(params, param_shardings(mesh)):
        p = p.detach()
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = mesh.shape[axis]
                if p.shape[dim] % n:
                    raise ValueError(
                        f"dim {dim} of size {p.shape[dim]} does not split "
                        f"over the {n} ranks of '{axis}'"
                    )
                size = p.shape[dim] // n
                p = p.narrow(dim, mesh.index(axis) * size, size)
        out.append(p.to(mesh.device))
    return _leaves(out)


class _ModelSum(torch.autograd.Function):
    """Sum over the ``"model"`` group in the forward; the backward passes
    the cotangent on (each rank's loss is the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        from ai_safety_gridworlds_torch.parallel.mesh import all_reduce

        return all_reduce(x.clone(), mesh, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def params_from_jax(params, device="cuda") -> ACParams:
    """A JAX ``ACParams`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, params)``) as the port's leaf tensors on ``device``."""
    dev = resolve_device(device)
    return _leaves(torch.from_numpy(np.array(getattr(params, f), np.float32))
                   .to(dev) for f in ACParams._fields)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest, ties to even) and held in
    float32; its backward rounds the cotangent the same way."""
    return x.to(torch.bfloat16).to(_F32)


def forward(params: ACParams, obs: torch.Tensor, mesh=None):
    """obs: f32 [batch, obs_dim] -> (logits [batch, n_actions], value
    [batch]). Under ``mesh`` the params are a rank's shards
    (:func:`shard_params`) and the second layer's partial sums meet over
    the ``"model"`` group."""
    h = torch.relu(_bf16(obs) @ _bf16(params.w1) + params.b1)
    part = _bf16(h) @ _bf16(params.w2)
    if mesh is not None and mesh.shape["model"] > 1:
        part = _ModelSum.apply(part, mesh)
    h2 = torch.relu(part + params.b2)
    # Both heads at once, as a broadcast product summed over the hidden
    # dim: elementwise float32 ops that no matmul precision switch (TF32)
    # reaches, in the forward or the backward.
    w = torch.cat([params.w_pi, params.w_v], dim=1)
    out = (h2[..., :, None] * w).sum(dim=-2) + torch.cat(
        [params.b_pi, params.b_v])
    return out[..., :-1], out[..., -1]


def perturbed_gap(key: torch.Tensor, logits: torch.Tensor,
                  lanes=None) -> torch.Tensor:
    """Each row's gap between its two largest perturbed logits, ``gumbel +
    logits`` from the ``categorical`` draw's key: ``[B]``. ``lanes`` as for
    :func:`_categorical`."""
    top = torch.topk(_gumbel(key, logits, lanes) + logits, 2,
                     dim=-1).values
    return top[:, 0] - top[:, 1]


def _gumbel(key, logits, lanes):
    """The categorical draw's gumbel noise for ``logits``' rows: the rows
    ``lo:hi`` of a ``[batch, A]`` draw when ``lanes`` is ``(lo, hi,
    batch)``."""
    if lanes is None:
        return threefry.gumbel(key, logits.shape)
    lo, hi, batch = lanes
    return threefry.gumbel(key, (batch, logits.shape[-1]))[lo:hi]


def _categorical(key, logits, lanes=None):
    """``threefry.categorical(key, logits)``; with ``lanes`` ``(lo, hi,
    batch)``, ``logits`` are rows ``lo:hi`` of the batch's and the draw is
    theirs of the batch's draw."""
    if lanes is None:
        return threefry.categorical(key, logits)
    return torch.argmax(_gumbel(key, logits, lanes) + logits,
                        dim=-1).to(torch.int32)


def _flat_obs(env, state) -> torch.Tensor:
    board = env.observe(state)["board"]
    return board.reshape(board.shape[0], -1).to(_F32)


def _check_device(params: ACParams, ep_batch) -> None:
    where = ep_batch.last_step_type.device
    if params.w1.device != where:
        raise ValueError(
            f"params lie on {params.w1.device}, the episodes on {where}")


def unroll_and_loss(
    params: ACParams,
    env,
    ep_batch,
    key,
    n_steps: int = 8,
    discount: float = 0.99,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    draw_gaps=None,
    mesh=None,
):
    """Collect ``n_steps`` with the current policy and compute the A2C
    loss; returns ``(loss, ep_batch)``. ``key`` is one threefry key (its
    ``split`` gives each step's ``categorical`` key, as JAX's scan). With a
    list ``draw_gaps``, each step appends each lane's :func:`perturbed_gap`:
    a gap below the last bits in which two implementations' logits differ
    may pick another action. Under ``mesh`` the params are the rank's
    shards, ``ep_batch`` its lanes of the batch split over ``"data"``, and
    the loss is the rank's part (the mean over its lanes)."""
    _check_device(params, ep_batch)
    step_keys = threefry.split(as_key(key, ep_batch.last_step_type.device),
                               n_steps)
    lanes = None
    if mesh is not None:
        local = ep_batch.last_step_type.shape[0]
        lo = mesh.index("data") * local
        lanes = (lo, lo + local, local * mesh.shape["data"])
    rows = []
    for t in range(n_steps):
        logits, value = forward(params, _flat_obs(env, ep_batch.env_state),
                                mesh)
        # Logit index i is action action_min + i.
        idx = _categorical(step_keys[t], logits.detach(), lanes)
        if draw_gaps is not None:
            draw_gaps.append(perturbed_gap(step_keys[t], logits.detach(),
                                           lanes))
        ep_batch, outs = base.episode_step(env, ep_batch,
                                           idx + env.action_min)
        logp_all = torch.log_softmax(logits, dim=-1)
        rows.append({
            "logp": logp_all.gather(1, idx.long()[:, None])[:, 0],
            "value": value,
            "entropy": -(torch.softmax(logits, dim=-1) * logp_all).sum(-1),
            "reward": outs.step.reward,
            "cont": (~outs.step.game_over).to(_F32),
        })
    _, bootstrap = forward(params, _flat_obs(env, ep_batch.env_state), mesh)

    ret = bootstrap.detach()
    returns = [None] * n_steps
    for t in range(n_steps - 1, -1, -1):
        ret = rows[t]["reward"] + discount * rows[t]["cont"] * ret
        returns[t] = ret
    returns = torch.stack(returns)
    value = torch.stack([r["value"] for r in rows])
    adv = returns - value
    logp = torch.stack([r["logp"] for r in rows])
    policy_loss = -torch.mean(adv.detach() * logp)
    value_loss = torch.mean(adv ** 2)
    entropy_loss = -torch.mean(torch.stack([r["entropy"] for r in rows]))
    loss = policy_loss + value_coef * value_loss + entropy_coef * entropy_loss
    return loss, ep_batch


def train_step(params: ACParams, env, ep_batch, key, lr: float = 1e-3,
               n_steps: int = 8, draw_gaps=None, mesh=None):
    """One SGD step on the A2C loss: ``(params, ep_batch, loss)`` with new
    leaf params (those given are left as they were) and the loss as a
    0-dim tensor. ``draw_gaps`` is :func:`unroll_and_loss`'s.

    Under ``mesh`` (a ``("data", "model")`` mesh): ``params`` are the
    rank's shards (:func:`shard_params`), ``ep_batch`` its lanes of the
    global batch; the gradients and the loss are averaged over ``"data"``
    (one all-reduce of every gradient as one flat buffer), so every rank
    returns its shards of the one-process step's params."""
    loss, ep_batch = unroll_and_loss(params, env, ep_batch, key,
                                     n_steps=n_steps, draw_gaps=draw_gaps,
                                     mesh=mesh)
    grads = torch.autograd.grad(loss, list(params))
    if mesh is not None:
        from ai_safety_gridworlds_torch.parallel.mesh import all_reduce

        flat = all_reduce(
            torch.cat([g.reshape(-1) for g in grads]
                      + [loss.detach().reshape(1)]),
            mesh, "data", mean=True)
        parts = flat.split([g.numel() for g in grads] + [1])
        grads = [part.view_as(g) for part, g in zip(parts, grads)]
        loss = parts[-1].reshape(())
    new = _leaves(p.detach() - lr * g for p, g in zip(params, grads))
    return new, ep_batch, loss.detach()

"""PPO trained on the fused multi-agent kernels.

Port of ``ai_safety_gridworlds_tpu/learners/ppo_fused.py``. The policy MLP
runs inside the collection kernel (K3 in ``ops/csrc/fused_firemaker.cu``
for firemaker_ex_ma, K5 in ``ops/csrc/fused_scalar.cu`` for the scalar
envs), which streams the per-step trajectory -- policy features, sampled actions,
logp, value, per-agent rewards summed over the reward dimensions, per-agent
dones -- as ``[T, rows, B]`` tensors (``FusedMaBase.rollout_collect``). One
``train_step`` is one collection launch followed by GAE and the minibatch
updates, in plain PyTorch autograd: the JAX package's gradient is XLA's
autodiff of the loss, outside any kernel.

The learner keeps the kernel's packed layout: GAE is a reverse loop over T
on ``[n, B]`` slabs, minibatches are fixed lane blocks (``[..., m*Lb:
(m+1)*Lb]``; each lane is an independent auto-resetting environment, so lane
blocks are i.i.d. samples), and the loss runs the MLP feature-major
(``einsum('hf,tfl->thl')``). Each agent is a trajectory stream of its own
with shared parameters; reset emissions and dead-agent steps carry
``action == -1`` and are masked out of the loss.

Params are a dict of float32 leaf tensors in the kernel's layout
(``mlp_w1`` [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1, H], ``mlp_b2``
[A+1, 1]; the last output row is the value head), the JAX package's names.
The optimizer is ``torch.optim.Adam`` after a global-norm clip written as
optax writes it (unchanged below ``max_grad_norm``, else ``g / norm *
max_norm``); both update the params in place.

Every entry point takes ``device``, ``"cuda"`` unless the caller passes
``"cpu"``; asking for CUDA without a card raises. CPU tensors run the plain
PyTorch collection. ``make_sharded_train_step`` is the data-parallel update
over a ``parallel.mesh.Mesh``: each rank collects on its lanes with one
launch of the collection kernel, and the minibatch gradients are averaged
over the ranks before the clip and Adam.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ai_safety_gridworlds_torch.ops import resolve_device
from ai_safety_gridworlds_torch.ops.fused_base import MLP_KEYS

_F32 = torch.float32


class FusedPPOConfig(NamedTuple):
    """Hyperparameters (the JAX package's fields and defaults)."""

    n_steps: int = 32          # rollout length per update
    n_epochs: int = 4          # passes over the rollout per update
    n_minibatches: int = 4     # lane blocks per pass
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 64


@dataclasses.dataclass
class FusedPPOState:
    """Everything a run needs to continue.

    ``params`` and ``opt`` are updated in place by each ``train_step``; the
    packed env state ``S`` and ``update_idx`` are replaced. The JAX
    package's state also carries a PRNG key, which its train step splits
    and never consumes (every draw comes from the packed state's per-lane
    keys), so the port has none."""

    params: dict
    opt: torch.optim.Optimizer
    S: dict
    update_idx: int = 0


def adam(plist, lr: float) -> torch.optim.Adam:
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8) over the leaf
    tensors ``plist``; the learners of the port share it."""
    return torch.optim.Adam(plist, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _optimizer(params: dict, config: FusedPPOConfig) -> torch.optim.Adam:
    return adam([params[k] for k in MLP_KEYS], config.lr)


def init_params(n_features: int, n_actions: int, hidden: int = 64,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """MLP params in the kernel's layout, at the JAX package's scales:
    ``mlp_w1`` ~ N(0, 1/F), policy rows of ``mlp_w2`` ~ N(0, 0.01^2)
    (near-uniform at init), the value row ~ N(0, 1/H), zero biases. Drawn
    on the host from ``generator`` (so a seed gives the same params on
    every device), then moved to ``device``."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    w1 = torch.randn(hidden, n_features, generator=g) * (
        1.0 / np.sqrt(n_features)
    )
    w2_pol = torch.randn(n_actions, hidden, generator=g) * 0.01
    w2_val = torch.randn(1, hidden, generator=g) / np.sqrt(hidden)
    params = {
        "mlp_w1": w1,
        "mlp_b1": torch.zeros(hidden, 1),
        "mlp_w2": torch.cat([w2_pol, w2_val], dim=0),
        "mlp_b2": torch.zeros(n_actions + 1, 1),
    }
    return {
        k: v.to(dev, _F32).contiguous().requires_grad_()
        for k, v in params.items()
    }


def forward(params: dict, obs: torch.Tensor):
    """Batch-major MLP head: obs [M, F] -> (logits [M, A], value [M])."""
    h = torch.relu(obs @ params["mlp_w1"].T + params["mlp_b1"][:, 0])
    out = h @ params["mlp_w2"].T + params["mlp_b2"][:, 0]
    return out[:, :-1], out[:, -1]


def init_train_state(fused, batch_size: int, seed: int = 0,
                     config: FusedPPOConfig = FusedPPOConfig(),
                     device="cuda",
                     generator: torch.Generator | None = None,
                     ) -> FusedPPOState:
    """Params from ``generator`` (seeded from ``seed`` when not given), the
    packed state ``init_packed(seed, batch_size)`` on ``device`` and a
    fresh optimizer."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params = init_params(
        fused.POLICY_FEATURES, fused.amax - fused.amin + 1,
        hidden=config.hidden, generator=generator, device=dev,
    )
    return FusedPPOState(
        params=params,
        opt=_optimizer(params, config),
        S=fused.init_packed(seed, batch_size, dev),
    )


def _gae_packed(traj: dict, bootstrap: torch.Tensor, config: FusedPPOConfig):
    """[T, n, B] advantages and returns by the reverse recurrence (standard
    GAE), on the kernel-layout slabs; the JAX package's order of
    operations."""
    reward, value, cont = traj["reward"], traj["value"], traj["cont"]
    adv = torch.empty_like(reward)
    next_value, next_adv = bootstrap, torch.zeros_like(bootstrap)
    for t in range(reward.shape[0] - 1, -1, -1):
        delta = reward[t] + config.discount * cont[t] * next_value - value[t]
        next_adv = delta + (
            config.discount * config.gae_lambda * cont[t] * next_adv
        )
        adv[t] = next_adv
        next_value = value[t]
    return adv, adv + value


def _loss_packed(params: dict, mb: dict, dims, config: FusedPPOConfig):
    """Clipped-surrogate PPO loss in the kernel's packed layout.

    ``mb``: feats [T, n*F, L], everything else [T, n, L] (L = lane-block
    width). The forward runs feature-major per agent, batched over T; the
    selected action's logp is a select chain over the A actions."""
    n, F, A, amin = dims
    feats, action = mb["feats"], mb["action"]
    logits_rows, value_rows = [], []
    for j in range(n):
        X = feats[:, j * F : (j + 1) * F, :]
        h = torch.relu(
            torch.einsum("hf,tfl->thl", params["mlp_w1"], X)
            + params["mlp_b1"][None, :, :]
        )
        out = (
            torch.einsum("ah,thl->tal", params["mlp_w2"], h)
            + params["mlp_b2"][None, :, :]
        )
        logits_rows.append(out[:, :A, :])
        value_rows.append(out[:, A, :])
    logits = torch.stack(logits_rows, dim=1)  # [T, n, A, L]
    value = torch.stack(value_rows, dim=1)  # [T, n, L]

    z = logits - logits.max(dim=2, keepdim=True).values.detach()
    log_se = torch.log(torch.exp(z).sum(dim=2))  # [T, n, L]
    aidx = torch.clamp(action - amin, min=0)
    z_sel = torch.zeros_like(log_se)
    for a in range(A):
        z_sel = z_sel + torch.where(aidx == a, z[:, :, a, :], 0.0)
    logp = z_sel - log_se

    p = torch.exp(z - log_se[:, :, None, :])
    entropy = -(p * (z - log_se[:, :, None, :])).sum(dim=2)
    return clipped_surrogate(logp, entropy, value, mb, config)


def clipped_surrogate(logp, entropy, value, mb: dict, config):
    """The PPO objective from each sample's ``logp`` of its action, policy
    ``entropy`` and ``value`` (any one layout, with ``mb``'s ``valid``,
    ``adv``, ``logp`` and ``ret`` in it): the masked-mean advantage
    normalization, the clipped surrogate, the squared value error and the
    entropy bonus, each averaged over the valid samples. The learners of
    the port share it. Returns ``(loss, metrics)``."""
    mask = mb["valid"]
    denom = torch.clamp(mask.sum(), min=1.0)
    adv = mb["adv"]
    adv_mean = (adv * mask).sum() / denom
    adv_std = torch.sqrt(((adv - adv_mean) ** 2 * mask).sum() / denom + 1e-8)
    adv = (adv - adv_mean) / adv_std

    ratio = torch.exp(logp - mb["logp"])
    clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
    policy_loss = (
        -(torch.minimum(ratio * adv, clipped * adv) * mask).sum() / denom
    )
    value_loss = (((value - mb["ret"]) ** 2) * mask).sum() / denom
    entropy = (entropy * mask).sum() / denom
    loss = (
        policy_loss
        + config.value_coef * value_loss
        - config.entropy_coef * entropy
    )
    return loss, {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
    }


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: unchanged when the global norm is below
    ``max_norm``, else every gradient times ``max_norm / norm``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _minibatches(traj: dict, boot: torch.Tensor, config: FusedPPOConfig):
    """GAE on the trajectory, then the ``n_minibatches`` lane blocks of the
    learner's data, in order."""
    cont = 1.0 - traj["done"].to(_F32)
    valid = (traj["action"] >= 0).to(_F32)
    with torch.no_grad():
        adv, ret = _gae_packed(
            {"reward": traj["reward"], "value": traj["value"], "cont": cont},
            boot.detach(), config,
        )
    data = {
        "feats": traj["feats"],
        "action": traj["action"],
        "logp": traj["logp"],
        "valid": valid,
        "adv": adv,
        "ret": ret,
    }
    B = traj["action"].shape[2]
    if B % config.n_minibatches:
        raise ValueError(
            f"batch {B} not divisible by n_minibatches {config.n_minibatches}"
        )
    Lb = B // config.n_minibatches
    return [
        {k: v[..., m * Lb : (m + 1) * Lb] for k, v in data.items()}
        for m in range(config.n_minibatches)
    ]


def _update_from_traj(traj: dict, boot: torch.Tensor, params: dict,
                      opt: torch.optim.Optimizer, dims,
                      config: FusedPPOConfig, grad_reduce=None) -> dict:
    """GAE and ``n_epochs`` x ``n_minibatches`` clipped, Adam-stepped
    gradient updates of ``params`` (in place) on a packed trajectory;
    shared by the single-device and sharded train steps. ``grad_reduce``
    (the sharded step's mean over the ranks) maps each minibatch's list of
    gradients before the clip. Returns the metrics as 0-dim tensors (no
    host sync): the losses and entropy averaged over the updates, completed
    episodes and the mean reward of valid agent-steps."""
    plist = [params[k] for k in MLP_KEYS]
    mbs = _minibatches(traj, boot, config)
    sums = {}
    for _ in range(config.n_epochs):
        for mb in mbs:
            loss, metrics = _loss_packed(params, mb, dims, config)
            grads = torch.autograd.grad(loss, plist)
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            grads = clip_by_global_norm(grads, config.max_grad_norm)
            for p, g in zip(plist, grads):
                p.grad = g
            opt.step()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
    n_updates = config.n_epochs * config.n_minibatches
    out = {k: v / n_updates for k, v in sums.items()}
    # One episode ends per step where all of a lane's agents read done (a
    # dead agent re-emits done every later step of its episode).
    out["episodes"] = (traj["done"] > 0).all(dim=1).sum().to(_F32)
    valid = (traj["action"] >= 0).to(_F32)
    out["mean_reward"] = (traj["reward"] * valid).sum() / torch.clamp(
        valid.sum(), min=1.0
    )
    return out


def _dims(fused):
    return (fused.n, fused.POLICY_FEATURES, fused.amax - fused.amin + 1,
            int(fused.amin))


def make_train_step(fused, config: FusedPPOConfig = FusedPPOConfig(),
                    device="cuda", tile: int | None = None):
    """The ``state -> (state, metrics)`` fused-PPO update on ``device``: one
    ``rollout_collect`` (one launch of the collection kernel on the card,
    the plain loop on the CPU), then :func:`_update_from_traj`."""
    dev = resolve_device(device)
    dims = _dims(fused)

    def train_step(state: FusedPPOState):
        if state.S["t"].device.type != dev.type:
            raise ValueError(
                f"train state lies on {state.S['t'].device}, the train step "
                f"was built for {dev}"
            )
        S, traj, boot = fused.rollout_collect(
            state.S, state.params, config.n_steps, tile=tile
        )
        metrics = _update_from_traj(
            traj, boot, state.params, state.opt, dims, config
        )
        return dataclasses.replace(
            state, S=S, update_idx=state.update_idx + 1
        ), metrics

    return train_step


def make_sharded_train_step(fused, mesh, config: FusedPPOConfig = FusedPPOConfig(),
                            axis: str = "data", tile: int | None = None):
    """The data-parallel fused-PPO update over ``mesh``'s ``axis``
    (``parallel.mesh.make_mesh``): returns ``(train_step, shard_state)``.

    The packed lane axis splits over ``axis``; params and the optimizer are
    replicated. Each rank's ``train_step`` makes one ``rollout_collect`` on
    its lanes (one launch of the collection kernel on the card), with the
    statics ``init_packed`` drew for the global batch sliced to its lanes,
    then :func:`_update_from_traj` with each minibatch's gradients averaged
    over the ranks (one all-reduce of the four as one flat buffer) before
    the global-norm clip and Adam, as the JAX package's ``pmean`` precedes
    optax's chain. The metrics are averaged over the ranks, ``episodes``
    then scaled by their count: a sum.

    As in the JAX package, advantage normalization and the loss's
    denominator are per rank. Every rank calls it with the same arguments
    and starts from the same state (``init_train_state`` from one seed).
    ``shard_state`` maps that global state to the rank's: its lanes of
    ``S`` (params and optimizer kept, on the mesh's device). A later
    ``init_packed`` of ``fused`` makes ``train_step`` raise
    ``RuntimeError``: rebuild it (and re-shard the state)."""
    from ai_safety_gridworlds_torch.ops.fused_base import shard_statics
    from ai_safety_gridworlds_torch.parallel.mesh import all_reduce

    dev = mesh.device
    dims = _dims(fused)
    n_dev = mesh.shape[axis]
    B = fused.packed_batch
    if B is None:
        raise ValueError("call init_packed before make_sharded_train_step")
    if B % n_dev:
        raise ValueError(
            f"packed batch {B} is not divisible by the mesh '{axis}' axis "
            f"({n_dev} devices); init_packed with a batch that is a "
            "multiple of the device count"
        )
    local = B // n_dev
    if local % config.n_minibatches:
        raise ValueError(
            f"per-device lane shard {local} (batch {B} / {n_dev} devices) "
            f"is not divisible by n_minibatches {config.n_minibatches}"
        )
    if tile is not None and not (tile % 32 == 0 and 32 <= tile <= 256):
        raise ValueError(
            f"per-device lane shard {local} (batch {B} / {n_dev} devices) "
            f"cannot launch at the lane tile {tile}: the kernels take a "
            "multiple of 32 in [32, 256]"
        )
    lo, hi = mesh.lanes(B, axis)
    statics = shard_statics(fused.statics_on(dev), lo, hi)
    # The statics are sliced at build time; a later init_packed (new
    # layouts) would leave the step on stale boards.
    statics_ref = fused._kstatics_np

    def grad_reduce(grads):
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh,
                          axis, mean=True)
        return [part.view_as(g) for part, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def train_step(state: FusedPPOState):
        if fused._kstatics_np is not statics_ref:
            raise RuntimeError(
                "the engine was re-packed (init_packed) after "
                "make_sharded_train_step sliced its statics: rebuild the "
                "sharded train step (and re-shard the state) to pick up "
                "the new layouts"
            )
        if state.S["t"].shape[1] != hi - lo or state.S["t"].device != dev:
            raise ValueError(
                f"train state holds {state.S['t'].shape[1]} lanes on "
                f"{state.S['t'].device}; this rank runs {hi - lo} on {dev} "
                "(shard_state)"
            )
        S, traj, boot = fused.rollout_collect(
            state.S, state.params, config.n_steps, tile=tile, statics=statics
        )
        metrics = _update_from_traj(traj, boot, state.params, state.opt,
                                    dims, config, grad_reduce=grad_reduce)
        names = sorted(metrics)
        means = all_reduce(torch.stack([metrics[k] for k in names]), mesh,
                           axis, mean=True)
        metrics = dict(zip(names, means.unbind()))
        metrics["episodes"] = metrics["episodes"] * n_dev
        return dataclasses.replace(
            state, S=S, update_idx=state.update_idx + 1
        ), metrics

    def shard_state(state: FusedPPOState) -> FusedPPOState:
        for k in MLP_KEYS:
            if state.params[k].device != dev:
                raise ValueError(
                    f"params lie on {state.params[k].device}, the mesh "
                    f"computes on {dev}"
                )
        if state.S["t"].shape[1] != B:
            raise ValueError(
                f"shard_state takes the global state of {B} lanes, got "
                f"{state.S['t'].shape[1]}"
            )
        return dataclasses.replace(state, S={
            k: v[:, lo:hi].contiguous().to(dev) for k, v in state.S.items()
        })

    return train_step, shard_state


def evaluate(fused, params: dict, n_steps: int = 256, batch: int = 1024,
             seed: int = 0, device="cuda", tile: int | None = None) -> dict:
    """Evaluate MLP policy ``params`` at collection-kernel speed.

    Runs ``n_steps`` over a fresh ``batch`` of auto-resetting lanes under
    the policy and computes exact per-episode returns from the emitted
    trajectory: each agent-stream's rewards accumulate and are harvested on
    the transition into done (a dead agent re-emits done), so partial tail
    episodes are excluded. Runs on a fresh kernel instance over the same
    env, as the JAX package does. Returns ``mean_episode_return`` (over
    completed per-agent episodes), ``episodes``, ``mean_step_reward`` and
    ``env_steps`` as Python numbers."""
    dev = resolve_device(device)
    eval_fused = type(fused)(fused.env)
    S = eval_fused.init_packed(seed, batch, dev)
    with torch.no_grad():
        _, traj, _ = eval_fused.rollout_collect(
            S, {k: params[k].detach() for k in MLP_KEYS}, n_steps, tile=tile
        )
        reward, done = traj["reward"], traj["done"].to(_F32)
        valid = (traj["action"] >= 0).to(_F32)
        acc = torch.zeros_like(reward[0])
        prev = torch.zeros_like(reward[0])
        returns, ends = [], []
        for t in range(n_steps):
            acc = acc + reward[t]
            first_done = done[t] * (1.0 - prev)
            returns.append(acc * first_done)
            ends.append(first_done)
            acc = acc * (1.0 - done[t])
            prev = done[t]
        n_episodes = torch.stack(ends).sum() if ends else torch.zeros(())
        total = torch.stack(returns).sum() if returns else torch.zeros(())
        mean_return = total / torch.clamp(n_episodes, min=1.0)
        mean_step = (reward * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return {
        "mean_episode_return": float(mean_return),
        "episodes": int(n_episodes),
        "mean_step_reward": float(mean_step),
        "env_steps": n_steps * batch,
    }

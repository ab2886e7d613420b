"""PPO over the generic batched auto-resetting chains.

Port of ``ai_safety_gridworlds_tpu/learners/ppo.py``: clipped-surrogate PPO
with GAE, minibatch epochs, Adam after a global-norm clip, on any env
through ``core/base.py`` (``episode_reset``, ``episode_step``) and the
``actor_critic`` MLP. The key chain is JAX's: ``split(key, 3)`` for the
next key, the rollout and the shuffles, ``split(k_roll, n_steps)`` with one
``categorical`` a step, ``split(k_perm, n_epochs)`` with one
``permutation`` of the ``n_steps * B`` samples an epoch; so a state carried
from JAX (``state_from_jax``) collects the same actions.

JAX jits the whole update into one program; here it is eager PyTorch on
the params' device: the collection under ``no_grad``, GAE (the fused
learner's ``_gae_packed``), then ``n_epochs`` x ``n_minibatches`` gradient
steps of :func:`ppo_fused.clipped_surrogate` through
:func:`ppo_fused.clip_by_global_norm` and :func:`ppo_fused.adam`, which
update the params in place (as ``ppo_fused``'s learner does) and carry the
optimizer in the state.

``init_train_state`` and ``make_train_step`` take ``device``, ``"cuda"``
unless the caller passes ``"cpu"``; asking for CUDA without a card raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import base, threefry
from ai_safety_gridworlds_torch.core.timestep import StepType
from ai_safety_gridworlds_torch.learners.actor_critic import (
    ACParams,
    as_key,
    forward,
    init_params,
    params_from_jax,
    perturbed_gap,
)
from ai_safety_gridworlds_torch.learners.ppo_fused import (
    _gae_packed,
    adam,
    clip_by_global_norm,
    clipped_surrogate,
)
from ai_safety_gridworlds_torch.ops import resolve_device

_F32 = torch.float32


class PPOConfig(NamedTuple):
    """Hyperparameters (the JAX package's fields and defaults)."""

    n_steps: int = 16          # rollout length per update
    n_epochs: int = 4          # passes over the rollout per update
    n_minibatches: int = 4     # minibatches per pass
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 128


@dataclasses.dataclass
class PPOState:
    """Everything a run needs to continue. ``params`` and ``opt`` (the
    Adam moments and count: JAX's ``opt_state``) are updated in place by
    each ``train_step``; ``ep_batch``, ``key`` and ``update_idx`` are
    replaced."""

    params: ACParams
    opt: torch.optim.Adam
    ep_batch: base.EpisodeState  # a batch of lanes
    key: torch.Tensor  # [2] threefry key
    update_idx: int = 0


def _optimizer(params: ACParams, config: PPOConfig) -> torch.optim.Adam:
    return adam(list(params), config.lr)


def _obs(env, state) -> torch.Tensor:
    """Flattened, centred board observation in [-1, 1): ``[B, H*W]``."""
    board = env.observe(state)["board"]
    return board.reshape(board.shape[0], -1).to(_F32) / 64.0 - 1.0


def init_train_state(env, key, batch_size: int,
                     config: PPOConfig = PPOConfig(),
                     device="cuda") -> PPOState:
    """JAX's ``init_train_state`` from the same key (an int seed or a
    ``[2]`` key): params, fresh episodes on ``batch_size`` lanes, a fresh
    optimizer and the run's key, on ``device``."""
    k = threefry.split(as_key(key, device), 3)
    ep_batch = base.episode_reset(env, threefry.split(k[1], batch_size))
    obs_dim = _obs(env, ep_batch.env_state).shape[1]
    params = init_params(k[0], obs_dim, env.action_max - env.action_min + 1,
                         hidden=config.hidden, device=k.device)
    return PPOState(params=params, opt=_optimizer(params, config),
                    ep_batch=ep_batch, key=k[2])


def _from_numpy(template, tree, device):
    """``tree`` (JAX's pytree as numpy, matched by field name) in the
    layout and dtypes of the port's ``template``; uint32 words become
    int64."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _from_numpy(getattr(template, f.name),
                                getattr(tree, f.name), device)
            for f in dataclasses.fields(template)
        })
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device, template.dtype)


def _adam_moments(opt_state):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside a
    chain's state tuple."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def state_from_jax(env, state, config: PPOConfig = PPOConfig(),
                   device="cuda") -> PPOState:
    """A JAX ``PPOState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``) as the port's: the params, optax's Adam count and
    moments, the episode batch (field by field, in the port env's state
    classes), the key and ``update_idx``."""
    dev = resolve_device(device)
    params = params_from_jax(state.params, dev)
    opt = _optimizer(params, config)
    moments = _adam_moments(state.opt_state)
    for p, mu, nu in zip(params, moments.mu, moments.nu):
        # torch.optim.Adam's state, as its first step would have made it
        # (the count on the host, in float32).
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(moments.count)),
                                 dtype=_F32),
            "exp_avg": torch.from_numpy(np.array(mu, np.float32)).to(dev),
            "exp_avg_sq": torch.from_numpy(np.array(nu, np.float32)).to(dev),
        }
    batch = np.asarray(state.ep_batch.last_step_type).shape[0]
    template = base.episode_reset(
        env, threefry.split(threefry.PRNGKey(0, dev), batch))
    return PPOState(
        params=params, opt=opt,
        ep_batch=_from_numpy(template, state.ep_batch, dev),
        key=torch.from_numpy(np.asarray(state.key).astype(np.int64)).to(dev),
        update_idx=int(np.asarray(state.update_idx)),
    )


def _collect(params: ACParams, env, ep_batch, key, config: PPOConfig,
             draw_gaps=None):
    """Roll ``n_steps`` with the current policy: the new episode batch, a
    ``[T, B]`` trajectory dict (obs kept for the minibatch passes) and the
    bootstrap value. With a list ``draw_gaps``, each step appends each
    lane's :func:`actor_critic.perturbed_gap`: where two implementations'
    logits differ in the last bits, a gap below that difference may pick
    the other action."""
    step_keys = threefry.split(key, config.n_steps)
    rows = []
    with torch.no_grad():
        for t in range(config.n_steps):
            obs = _obs(env, ep_batch.env_state)
            logits, value = forward(params, obs)
            idx = threefry.categorical(step_keys[t], logits)
            if draw_gaps is not None:
                draw_gaps.append(perturbed_gap(step_keys[t], logits))
            ep_batch, outs = base.episode_step(env, ep_batch,
                                               idx + env.action_min)
            logp = torch.log_softmax(logits, dim=-1).gather(
                1, idx.long()[:, None])[:, 0]
            rows.append({
                "obs": obs,
                "action": idx,
                "logp": logp,
                "value": value,
                "reward": outs.step.reward,
                "cont": 1.0 - outs.step.game_over.to(_F32),
                # Auto-reset emissions (FIRST, zero reward, ignored action)
                # carry no learning signal: masked out of the loss.
                "valid": (outs.step.step_type
                          != int(StepType.FIRST)).to(_F32),
            })
        _, bootstrap = forward(params, _obs(env, ep_batch.env_state))
    traj = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return ep_batch, traj, bootstrap


# JAX's ``_gae``: [T, B] advantages and returns by the reverse recurrence,
# the fused learner's on any trailing layout.
_gae = _gae_packed


def _loss(params: ACParams, mb: dict, config: PPOConfig):
    """The clipped-surrogate loss of one flat minibatch (``obs`` [M, F],
    the rest [M])."""
    logits, value = forward(params, mb["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, mb["action"].long()[:, None])[:, 0]
    entropy = -(torch.softmax(logits, dim=-1) * logp_all).sum(-1)
    return clipped_surrogate(logp, entropy, value, mb, config)


def _update(params: ACParams, opt: torch.optim.Adam, traj: dict,
            bootstrap: torch.Tensor, key: torch.Tensor,
            config: PPOConfig) -> dict:
    """GAE on the ``[T, B]`` trajectory, then ``n_epochs`` passes over its
    ``T * B`` samples in the order of one ``permutation`` of
    ``split(key, n_epochs)`` each, ``n_minibatches`` clipped Adam steps a
    pass, updating ``params`` in place. Returns the metrics as 0-dim
    tensors: the losses and entropy averaged over the updates, the
    episodes ended and the mean reward of valid steps."""
    adv, ret = _gae(traj, bootstrap, config)
    data = {k: traj[k] for k in ("obs", "action", "logp", "valid")}
    data.update(adv=adv, ret=ret)
    n = config.n_steps * traj["reward"].shape[1]
    flat = {k: v.reshape((n,) + v.shape[2:]) for k, v in data.items()}
    mb_size = n // config.n_minibatches
    plist = list(params)
    sums = {}
    for epoch_key in threefry.split(key, config.n_epochs):
        order = threefry.permutation(epoch_key, n).long()
        shuffled = {k: v[order] for k, v in flat.items()}
        for m in range(config.n_minibatches):
            mb = {k: v[m * mb_size:(m + 1) * mb_size]
                  for k, v in shuffled.items()}
            loss, metrics = _loss(params, mb, config)
            grads = clip_by_global_norm(torch.autograd.grad(loss, plist),
                                        config.max_grad_norm)
            for p, g in zip(plist, grads):
                p.grad = g
            opt.step()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
    n_updates = config.n_epochs * config.n_minibatches
    out = {k: v / n_updates for k, v in sums.items()}
    out["episodes"] = (1.0 - traj["cont"]).sum()
    out["mean_reward"] = (traj["reward"] * traj["valid"]).sum() / (
        torch.clamp(traj["valid"].sum(), min=1.0))
    return out


def make_train_step(env, config: PPOConfig = PPOConfig(), device="cuda",
                    draw_gaps=None):
    """The ``state -> (state, metrics)`` PPO update on ``device``: one
    :func:`_collect` and one :func:`_update`; the metrics are 0-dim
    tensors, fetched by nobody. ``draw_gaps`` is :func:`_collect`'s."""
    dev = resolve_device(device)

    def train_step(state: PPOState):
        if state.key.device.type != dev.type:
            raise ValueError(
                f"train state lies on {state.key.device}, the train step "
                f"was built for {dev}"
            )
        k = threefry.split(state.key, 3)
        ep_batch, traj, bootstrap = _collect(
            state.params, env, state.ep_batch, k[1], config, draw_gaps)
        metrics = _update(state.params, state.opt, traj, bootstrap, k[2],
                          config)
        return dataclasses.replace(
            state, ep_batch=ep_batch, key=k[0],
            update_idx=state.update_idx + 1,
        ), metrics

    return train_step

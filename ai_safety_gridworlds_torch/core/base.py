"""The functional safety-gridworld protocol and the generic batched path.

Port of ``ai_safety_gridworlds_tpu/core/base.py``. JAX writes each env for
one instance and ``jax.vmap``s it; here every function works on a batch of
lanes with a leading dim ``[B, ...]``. A state is a dataclass of tensors
(``t`` ``[B]`` int32, ``key`` ``[B, 2]`` threefry words in int64, ...) with
JAX's field names and dtypes, so a port state compares with the output of
``jax.vmap`` field by field. Where JAX has ``lax.cond`` under ``vmap`` (the
auto-reset), both branches are computed for every lane and selected with
``torch.where``, as XLA does, so the key chain is JAX's.

:func:`rollout` is the generic batched rollout behind
``BatchedEnv(..., backend="generic")``: the keys are split as JAX splits
them (``split(key, batch_size + 1)``, the step keys from the first, the
reset branch's two splits), so it equals ``jax.jit(core.base.rollout)``
from the same key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_torch.ops import resolve_device

_I32 = torch.int32
_F32 = torch.float32
NONE = int(TerminationReason.NONE)


class Struct:
    """Base of the state dataclasses: ``replace`` as flax's structs have."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching (nested) dataclasses."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
        })
    return fn(*trees)


def tree_where(cond: torch.Tensor, new, old):
    """Per lane, ``new`` where ``cond`` ([B] bool) else ``old``, over every
    leaf (``jnp.where`` of a lane predicate under ``vmap``)."""
    def sel(a, b):
        c = cond.view(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)
    return tree_map(sel, new, old)


@dataclasses.dataclass
class EngineStep(Struct):
    """What one game iteration communicated to the engine, per lane."""

    reward: Any  # f32 [B] (scalar suite) or [B, n_dims] (MO suite)
    hidden_reward: torch.Tensor  # f32 [B]
    hidden_written: torch.Tensor  # bool [B]
    terminated: torch.Tensor  # bool [B]
    termination_reason: torch.Tensor  # int32 [B]
    discount: torch.Tensor  # f32 [B]
    actual_action: torch.Tensor  # int32 [B]

    @classmethod
    def make(
        cls,
        reward,
        *,
        hidden_reward=0.0,
        hidden_written=None,
        terminated=False,
        termination_reason=NONE,
        discount=0.0,
        actual_action=-1,
    ) -> "EngineStep":
        """Every field broadcast to the lanes of ``reward`` (a tensor with
        a leading batch dim) in JAX's dtype."""
        batch = reward.shape[:1]
        dev = reward.device

        def lanes(x, dtype):
            if isinstance(x, torch.Tensor):
                return x.to(dtype).expand(batch)
            return torch.full(batch, x, dtype=dtype, device=dev)

        hidden_reward = lanes(hidden_reward, _F32)
        if hidden_written is None:
            # A nonzero delta implies a write; envs whose writes can cancel
            # to zero pass the flag explicitly.
            hidden_written = hidden_reward != 0.0
        return cls(
            reward=reward.to(_F32),
            hidden_reward=hidden_reward,
            hidden_written=lanes(hidden_written, torch.bool),
            terminated=lanes(terminated, torch.bool),
            termination_reason=lanes(termination_reason, _I32),
            discount=lanes(discount, _F32),
            actual_action=lanes(actual_action, _I32),
        )


@dataclasses.dataclass
class StepOut(Struct):
    """Result of one environment step, before observation rendering."""

    step_type: torch.Tensor  # int32 [B]
    reward: Any  # f32 [B] or [B, n_dims]
    discount: torch.Tensor  # f32 [B]
    game_over: torch.Tensor  # bool [B]: this step emitted LAST
    termination_reason: torch.Tensor  # int32 [B]
    hidden_reward: torch.Tensor  # f32 [B]
    hidden_written: torch.Tensor  # bool [B]
    actual_action: torch.Tensor  # int32 [B]


class SafetyGridworld:
    """Base class of the functional env families.

    Subclasses define ``initial_state(key [B, 2], options) -> State`` (a
    :class:`Struct` dataclass with at least ``t`` and ``key``),
    ``engine_step(state, action [B], options) -> (State, EngineStep)`` and
    ``observe(state) -> dict``. ``max_iterations`` bounds an episode;
    ``action_min``/``action_max`` is the inclusive action range.
    """

    max_iterations: int = 100
    action_min: int = 1
    action_max: int = 4
    default_reward: float = 0.0

    def const(self, name: str, device) -> torch.Tensor:
        """The host table ``self.<name>`` as a tensor on ``device``, made
        once per device (a copy per step would stall the card's queue)."""
        cache = self.__dict__.setdefault("_device_consts", {})
        key = (name, str(device))
        t = cache.get(key)
        if t is None:
            t = cache[key] = torch.as_tensor(getattr(self, name), device=device)
        return t

    def drop_device_tables(self):
        """Forget every per-device table (the ``_device_*`` caches); each is
        remade from the host tables on first use, so a board that changed
        on the host is uploaded anew."""
        for name in [k for k in self.__dict__ if k.startswith("_device_")]:
            del self.__dict__[name]

    def __getstate__(self):
        # The per-device tables are remade on first use: a pickle holds
        # nothing bound to a device.
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_device_")}

    def initial_state(self, key, options=None):
        raise NotImplementedError

    def host_reset_options(self) -> dict:
        """Per-episode randomization drawn on the host from numpy's global
        RNG as the reference draws it (numpy values): the stateful shell
        (``helpers/safety_env.py``) calls it on every reset, the probe
        episode's included."""
        return {}

    def host_step_options(self, state, action: int) -> dict:
        """This step's randomness drawn on the host from numpy's global RNG
        as the reference draws it, for the shell's one lane (``action`` is
        the pending action); none by default."""
        return {}

    def sample_reset_options(self, key) -> dict:
        """Per-episode randomization drawn on the device (none here)."""
        return {}

    def carry_state_across_reset(self, old_state, new_state):
        """Cross-episode state carried into a fresh episode at auto-reset."""
        del old_state
        return new_state

    def engine_step(self, state, action, options=None):
        raise NotImplementedError

    def observe(self, state) -> dict:
        raise NotImplementedError

    def episode_performance(self, episode_return, hidden_return):
        """Per-episode safety performance: the episode return by default;
        hidden-reward envs return ``hidden_return``."""
        return episode_return

    def step(self, state, action, options=None):
        """One full environment step: frame count, physics, termination."""
        action = action.to(_I32)
        state = state.replace(t=state.t + 1)
        state, es = self.engine_step(state, action, options)
        truncated = state.t >= self.max_iterations
        game_over = es.terminated | truncated
        # A directive reason wins over MAX_STEPS.
        reason = torch.where(
            es.terminated,
            es.termination_reason,
            torch.where(truncated, int(TerminationReason.MAX_STEPS), NONE)
            .to(_I32),
        )
        out = StepOut(
            step_type=torch.where(
                game_over, int(StepType.LAST), int(StepType.MID)
            ).to(_I32),
            reward=es.reward,
            discount=torch.where(es.terminated, es.discount, 1.0),
            game_over=game_over,
            termination_reason=reason,
            hidden_reward=es.hidden_reward,
            hidden_written=es.hidden_written,
            actual_action=es.actual_action,
        )
        return state, out

    def zero_reward(self, batch: int, device) -> torch.Tensor:
        """A zero of the env's reward type for each lane ([B] here)."""
        return torch.zeros((batch,), dtype=_F32, device=device)


@dataclasses.dataclass
class EpisodeState(Struct):
    """Carries the lanes through an auto-resetting rollout."""

    env_state: Any
    last_step_type: torch.Tensor  # int32 [B]
    episode_return: Any  # f32 [B] or [B, n_dims]
    hidden_return: torch.Tensor  # f32 [B]


@dataclasses.dataclass
class EpisodeOut(Struct):
    """Per-step rollout output: the StepOut plus episode accounting."""

    step: StepOut
    # Valid only where ``step.game_over``: the ended episode's returns.
    final_return: Any
    final_hidden: torch.Tensor


def episode_reset(env: SafetyGridworld, key) -> EpisodeState:
    """Start a fresh episode on each lane (the FIRST timestep's state)."""
    k = threefry.split(key)
    key, opt_key = k[:, 0], k[:, 1]
    options = env.sample_reset_options(opt_key)
    env_state = env.initial_state(key, options)
    batch, dev = key.shape[0], key.device
    return EpisodeState(
        env_state=env_state,
        last_step_type=torch.full((batch,), int(StepType.FIRST), dtype=_I32,
                                  device=dev),
        episode_return=env.zero_reward(batch, dev),
        hidden_return=torch.zeros((batch,), dtype=_F32, device=dev),
    )


def episode_step(env: SafetyGridworld, ep: EpisodeState, action) -> tuple:
    """Auto-resetting step: a lane whose last step was LAST resets and
    emits FIRST with zero reward; the others step."""
    batch, dev = action.shape[0], action.device

    # The reset branch, for every lane.
    k = threefry.split(ep.env_state.key)
    reset = episode_reset(env, k[:, 1])
    reset = reset.replace(env_state=env.carry_state_across_reset(
        ep.env_state, reset.env_state.replace(key=k[:, 0])
    ))
    false = torch.zeros((batch,), dtype=torch.bool, device=dev)
    zf = torch.zeros((batch,), dtype=_F32, device=dev)
    reset_out = EpisodeOut(
        step=StepOut(
            step_type=torch.full((batch,), int(StepType.FIRST), dtype=_I32,
                                 device=dev),
            reward=env.zero_reward(batch, dev),
            discount=torch.ones((batch,), dtype=_F32, device=dev),
            game_over=false,
            termination_reason=torch.full((batch,), NONE, dtype=_I32,
                                          device=dev),
            hidden_reward=zf,
            hidden_written=false,
            actual_action=torch.full((batch,), -1, dtype=_I32, device=dev),
        ),
        final_return=env.zero_reward(batch, dev),
        final_hidden=zf,
    )

    # The step branch, for every lane.
    env_state, out = env.step(ep.env_state, action)
    episode_return = ep.episode_return + out.reward
    hidden_return = ep.hidden_return + out.hidden_reward
    stepped = EpisodeState(
        env_state=env_state,
        last_step_type=out.step_type,
        episode_return=episode_return,
        hidden_return=hidden_return,
    )
    step_out = EpisodeOut(
        step=out, final_return=episode_return, final_hidden=hidden_return
    )

    need_reset = ep.last_step_type == int(StepType.LAST)
    return (
        tree_where(need_reset, reset, stepped),
        tree_where(need_reset, reset_out, step_out),
    )


def random_policy(env: SafetyGridworld) -> Callable:
    """Uniform-random actions over the env's range, one key per lane."""

    def policy(keys, ep):
        return threefry.randint(keys, (), env.action_min, env.action_max + 1)

    return policy


def sum_steps(per_step: list) -> dict:
    """Each statistic summed over the steps in its own dtype (the per-step
    sums first, as JAX's scan output is summed)."""
    return {
        k: torch.stack([s[k] for s in per_step]).sum(dim=0, dtype=v.dtype)
        for k, v in per_step[0].items()
    }


def rollout(
    env: SafetyGridworld,
    key,
    n_steps: int,
    batch_size: int,
    policy: Optional[Callable] = None,
    collect: bool = False,
    device="cuda",
):
    """Batched auto-resetting rollout on ``device``.

    ``key`` is a threefry key (``[2]`` tensor, or an int seed for
    ``PRNGKey``); ``policy(step_key [2], ep_batch) -> int32 [B]``, by
    default uniform random with one key per lane (``split(step_key, B)``).
    Returns ``(final_ep_state, stats[, outs])``: ``episodes`` (int32),
    ``sum_final_return`` and ``sum_final_hidden`` (float32 sums of the
    finished episodes' returns, per step then over steps, as JAX's scan);
    with ``collect`` the per-step ``EpisodeOut`` stacked on a leading time
    dim.
    """
    device = resolve_device(device)
    if not isinstance(key, torch.Tensor):
        key = threefry.PRNGKey(key)
    key = key.to(device)
    if policy is None:
        base_policy = random_policy(env)

        def policy(k, eps):
            return base_policy(threefry.split(k, batch_size), None)

    init_keys = threefry.split(key, batch_size + 1)
    eps = episode_reset(env, init_keys[1:])
    step_keys = threefry.split(init_keys[0], n_steps)
    per_step, outs_all = [], []
    for s in range(n_steps):
        actions = policy(step_keys[s], eps)
        eps, outs = episode_step(env, eps, actions)
        done = outs.step.game_over
        fr = outs.final_return
        dmask = done.view(done.shape + (1,) * (fr.dim() - 1))
        per_step.append({
            "episodes": done.sum(dtype=_I32),
            "sum_final_return": torch.where(dmask, fr, 0.0).sum(),
            "sum_final_hidden": torch.where(done, outs.final_hidden, 0.0).sum(),
        })
        if collect:
            outs_all.append(outs)
    stats = sum_steps(per_step)
    if collect:
        stacked = tree_map(lambda *xs: torch.stack(xs), *outs_all)
        return eps, stats, stacked
    return eps, stats

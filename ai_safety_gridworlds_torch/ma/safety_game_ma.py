"""The multi-agent (MO+MA) functional base and the batched MA rollout.

Port of ``ai_safety_gridworlds_tpu/ma/safety_game_ma.py`` (the functional
part) on a batch of lanes. One env step is a permutation of the acting
agents, drawn per lane from the env key; each agent's sub-step runs a full
engine sweep and advances the frame counter by one. An agent's episode
ends when it records a termination reason, the lane's when every agent has
one or ``t`` reaches ``max_iterations``; per-agent step types go
MID -> LAST -> DEAD, and rewards are ``[B, n_agents, n_dims]``.

Subclasses implement ``engine_substep(state, agent_idx [B], action [B],
options, slot) -> (state, rewards [B, n, D])``; the base runs the
sub-steps in the drawn order, each gated on its agent acting.

For the stateful multi-agent shells, two host pieces: ``host_agent_order``
(the reference's ``Generator.shuffle`` of the acting agents, passed to the
step as ``agent_order``) and :func:`agent_perspective` (the agent-centric
crop, pad and rotation of a board or layer stack on the host).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import threefry
from ai_safety_gridworlds_torch.core.actions import Directions
from ai_safety_gridworlds_torch.core.base import Struct, sum_steps, tree_where
from ai_safety_gridworlds_torch.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_torch.mo.mo_reward import mo_reward
from ai_safety_gridworlds_torch.mo.safety_game_mo import MoSafetyGridworld
from ai_safety_gridworlds_torch.ops import resolve_device

_I32 = torch.int32
NONE = int(TerminationReason.NONE)


@dataclasses.dataclass
class MaEngineStep(Struct):
    """What one full MA step (all sub-steps) communicated to the engine."""

    rewards: torch.Tensor  # f32 [B, n_agents, n_dims]
    termination_reasons: torch.Tensor  # int32 [B, n_agents]
    discount: torch.Tensor  # f32 [B]


@dataclasses.dataclass
class MaStepOut(Struct):
    step_types: torch.Tensor  # int32 [B, n_agents]
    rewards: torch.Tensor  # f32 [B, n_agents, n_dims]
    discount: torch.Tensor  # f32 [B]
    game_over: torch.Tensor  # bool [B]: the episode ended for everyone
    termination_reasons: torch.Tensor  # int32 [B, n_agents]


def add_row(rewards, idx, vec):
    """``rewards.at[idx].add(vec)`` per lane: ``rewards`` [B, n, D],
    ``idx`` an int or a [B] tensor of agent indices, ``vec`` [B, D]."""
    if not isinstance(idx, torch.Tensor):
        out = rewards.clone()
        out[:, idx] += vec
        return out
    batch, _, dims = rewards.shape
    index = idx.long().view(batch, 1, 1).expand(batch, 1, dims)
    # One add into each (lane, idx) row: no two adds meet, so the result
    # does not depend on their order.
    return rewards.scatter_add(1, index, vec.reshape(batch, 1, dims))


class MaSafetyGridworld(MoSafetyGridworld):
    """Functional base of the multi-agent multi-objective envs.

    A state carries at least ``t``, ``key``, ``pos`` (int32 [B, n, 2]),
    ``termination_reasons`` and ``step_types`` (int32 [B, n]).
    """

    n_agents: int = 2
    agent_chars: str = "12"
    randomize_agent_actions_order: bool = True

    def engine_substep(self, state, agent_idx, action, options, slot):
        raise NotImplementedError

    def agent_reward_keys(self) -> dict:
        """Per-agent enabled reward dimension keys; the step works in the
        union space (``self.reward_space``)."""
        enabled_ma = getattr(self, "enabled_ma_rewards", None)
        if enabled_ma is not None:
            return {
                a: mo_reward.get_enabled_reward_dimension_keys(rewards)
                for a, rewards in enabled_ma.items()
            }
        return {
            c: list(self.reward_space.keys)
            for c in self.agent_chars[: self.n_agents]
        }

    def zero_rewards(self, batch: int, device) -> torch.Tensor:
        return torch.zeros(
            (batch, self.n_agents, self.reward_space.n_dims),
            dtype=torch.float32, device=device,
        )

    def apply_substep(self, state, agent_idx, action, options, slot):
        """One gated sub-step: advances the frame and applies the acting
        agent's engine sweep on lanes where ``action >= 0``."""
        action = action.to(_I32)
        acting = action >= 0
        new_state, delta = self.engine_substep(
            state.replace(t=state.t + 1), agent_idx, action, options, slot
        )
        state = tree_where(acting, new_state, state)
        return state, torch.where(acting[:, None, None], delta, 0.0)

    def finalize_step(self, state, rewards):
        """Truncation, per-agent step types, termination reasons, discount."""
        truncated = (state.t >= self.max_iterations)[:, None]
        reasons = state.termination_reasons
        over_agent = truncated | (reasons != NONE)
        prev = state.step_types
        fresh = (prev == int(StepType.MID)) | (prev == int(StepType.FIRST))
        step_types = torch.where(
            over_agent,
            torch.where(fresh, int(StepType.LAST), int(StepType.DEAD)),
            int(StepType.MID),
        ).to(_I32)
        state = state.replace(step_types=step_types)
        reasons_out = torch.where(
            reasons != NONE,
            reasons,
            torch.where(truncated, int(TerminationReason.MAX_STEPS), NONE)
            .to(_I32),
        )
        discount = torch.where((reasons != NONE).all(dim=1), 0.0, 1.0)
        return state, MaStepOut(
            step_types=step_types,
            rewards=rewards,
            discount=discount,
            game_over=over_agent.all(dim=1),
            termination_reasons=reasons_out,
        )

    def step(self, state, actions, options=None):
        """One full MA step: ``actions`` int32 [B, n_agents], -1 where an
        agent does not act; ``options`` may carry ``agent_order`` [B, n]
        and env-specific per-sub-step draws. Returns (state, MaStepOut)."""
        actions = actions.to(_I32)
        n = self.n_agents
        batch, dev = actions.shape[0], actions.device
        if options is not None and "agent_order" in options:
            order = options["agent_order"].to(_I32)
        elif self.randomize_agent_actions_order and n > 1:
            k = threefry.split(state.key)
            order = threefry.permutation(k[:, 1], n)
            state = state.replace(key=k[:, 0])
        else:
            order = torch.arange(n, dtype=_I32, device=dev).expand(batch, n)
        rewards = self.zero_rewards(batch, dev)
        for slot in range(n):
            agent_idx = order[:, slot]
            action = actions.gather(1, agent_idx.long()[:, None])[:, 0]
            state, delta = self.apply_substep(
                state, agent_idx, action, options, slot
            )
            rewards = rewards + delta
        return self.finalize_step(state, rewards)

    def host_agent_order(self, np_random, acting_agents) -> np.ndarray:
        """The acting agents shuffled by ``np_random.shuffle`` as the
        reference shuffles its actions, then the agents that do not act:
        int32 [n_agents], the step's ``agent_order`` for one lane."""
        items = list(acting_agents)
        if self.randomize_agent_actions_order and len(items) > 1:
            np_random.shuffle(items)
        rest = [i for i in range(self.n_agents) if i not in set(items)]
        return np.asarray(items + rest, dtype=np.int32)


def agent_perspective(
    board: np.ndarray,
    position,
    observation_direction: int,
    what_lies_outside,
    observation_radius=None,
    observation_direction_mode: int = 0,
) -> np.ndarray:
    """The agent-centric view of a board ([H, W]) or layer stack ([H, W,
    ...]) on the host: crop by the visibility in each direction, pad
    outside the board with ``what_lies_outside``, then turn by quarter
    turns so that the agent's observation direction faces up (only when
    the direction mode is not fixed). ``observation_radius`` is None (the
    whole board, agent-centric), a scalar, a 4-list indexed by
    ``Directions``, or -1 (the global view, unchanged)."""
    h, w = board.shape[:2]
    row, col = int(position[0]), int(position[1])

    if observation_radius is None:
        if observation_direction_mode == 0:
            left = right = w - 1
            top = bottom = h - 1
        else:
            m = max(h, w)
            left = right = top = bottom = m - 1
    elif np.isscalar(observation_radius):
        if observation_radius == -1:
            return board
        left = right = top = bottom = int(observation_radius)
    else:
        r = observation_radius
        if observation_direction_mode == 0:
            left, right = r[Directions.LEFT], r[Directions.RIGHT]
            top, bottom = r[Directions.UP], r[Directions.DOWN]
        else:
            d = observation_direction
            if d == Directions.UP:
                left, right = r[Directions.LEFT], r[Directions.RIGHT]
                top, bottom = r[Directions.UP], r[Directions.DOWN]
            elif d == Directions.DOWN:
                left, right = r[Directions.RIGHT], r[Directions.LEFT]
                top, bottom = r[Directions.DOWN], r[Directions.UP]
            elif d == Directions.LEFT:
                left, right = r[Directions.UP], r[Directions.DOWN]
                top, bottom = r[Directions.RIGHT], r[Directions.LEFT]
            elif d == Directions.RIGHT:
                left, right = r[Directions.DOWN], r[Directions.UP]
                top, bottom = r[Directions.LEFT], r[Directions.RIGHT]
            else:
                raise ValueError("Invalid observation_direction")

    out = board[
        max(0, row - top) : row + bottom + 1,
        max(0, col - left) : col + right + 1,
    ]
    fill = what_lies_outside
    if row - top < 0:
        pad = np.full((top - row,) + out.shape[1:], fill, board.dtype)
        out = np.concatenate([pad, out], axis=0)
    if row + bottom + 1 > h:
        pad = np.full(
            (row + bottom + 1 - h,) + out.shape[1:], fill, board.dtype
        )
        out = np.concatenate([out, pad], axis=0)
    if col - left < 0:
        pad = np.full(
            (out.shape[0], left - col) + out.shape[2:], fill, board.dtype
        )
        out = np.concatenate([pad, out], axis=1)
    if col + right + 1 > w:
        pad = np.full(
            (out.shape[0], col + right + 1 - w) + out.shape[2:],
            fill,
            board.dtype,
        )
        out = np.concatenate([out, pad], axis=1)

    if observation_direction_mode != 0:
        d = observation_direction
        if d == Directions.DOWN:
            out = np.rot90(out, k=2)
        elif d == Directions.LEFT:
            out = np.rot90(out, k=-1)
        elif d == Directions.RIGHT:
            out = np.rot90(out, k=1)
    return out


@dataclasses.dataclass
class MaEpisodeState(Struct):
    """Carries the MA lanes through an auto-resetting rollout."""

    env_state: Any
    episode_returns: torch.Tensor  # f32 [B, n_agents, n_dims]


@dataclasses.dataclass
class MaEpisodeOut(Struct):
    step: MaStepOut
    # Valid only where ``step.game_over``: the ended episode's returns.
    final_returns: torch.Tensor


def ma_episode_reset(env: MaSafetyGridworld, key) -> MaEpisodeState:
    k = threefry.split(key)
    options = env.sample_reset_options(k[:, 1])
    return MaEpisodeState(
        env_state=env.initial_state(k[:, 0], options),
        episode_returns=env.zero_rewards(key.shape[0], key.device),
    )


def ma_episode_step(env: MaSafetyGridworld, ep: MaEpisodeState, actions):
    """Auto-resetting MA step: a lane whose episode ended for every agent
    resets (FIRST, zero rewards); the others step, with dead agents' actions
    gated to -1 so that no sub-step runs for them."""
    n = env.n_agents
    batch, dev = actions.shape[0], actions.device

    k = threefry.split(ep.env_state.key)
    reset = ma_episode_reset(env, k[:, 1])
    reset = reset.replace(env_state=reset.env_state.replace(key=k[:, 0]))
    reset_out = MaEpisodeOut(
        step=MaStepOut(
            step_types=torch.full((batch, n), int(StepType.FIRST),
                                  dtype=_I32, device=dev),
            rewards=env.zero_rewards(batch, dev),
            discount=torch.ones((batch,), dtype=torch.float32, device=dev),
            game_over=torch.zeros((batch,), dtype=torch.bool, device=dev),
            termination_reasons=torch.full((batch, n), NONE, dtype=_I32,
                                           device=dev),
        ),
        final_returns=env.zero_rewards(batch, dev),
    )

    alive = ep.env_state.termination_reasons == NONE
    gated = torch.where(alive, actions.to(_I32), -1)
    env_state, out = env.step(ep.env_state, gated)
    returns = ep.episode_returns + out.rewards
    stepped = MaEpisodeState(env_state=env_state, episode_returns=returns)
    step_out = MaEpisodeOut(
        step=out,
        final_returns=torch.where(out.game_over[:, None, None], returns, 0.0),
    )

    types = ep.env_state.step_types
    was_over = (
        (types == int(StepType.LAST)) | (types == int(StepType.DEAD))
    ).all(dim=1)
    return (
        tree_where(was_over, reset, stepped),
        tree_where(was_over, reset_out, step_out),
    )


def ma_rollout(
    env: MaSafetyGridworld,
    key,
    n_steps: int,
    batch_size: int,
    policy=None,
    device="cuda",
    lane_stats: bool = False,
):
    """Batched auto-resetting MA rollout on ``device``.

    ``policy(step_key [2], ep_batch) -> int32 [B, n_agents]``; by default
    uniform random over the action range for every agent, drawn with one
    key per step (``randint(step_key, (B, n))``). Returns (final episode
    state, stats): ``episodes`` (int32) and ``sum_final_returns``
    (float32 [n_agents, n_dims], the finished episodes' returns summed per
    step, then over steps, as JAX's scan). ``lane_stats`` adds the same
    per lane, ``lane_episodes`` (int32 [B]) and ``lane_final_returns``
    (float32 [B, n_agents, n_dims], added step by step), so that lanes can
    be compared one by one.
    """
    device = resolve_device(device)
    if not isinstance(key, torch.Tensor):
        key = threefry.PRNGKey(key)
    key = key.to(device)
    n = env.n_agents
    if policy is None:

        def policy(k, eps):
            return threefry.randint(
                k, (batch_size, n), env.action_min, env.action_max + 1
            )

    init_keys = threefry.split(key, batch_size + 1)
    eps = ma_episode_reset(env, init_keys[1:])
    step_keys = threefry.split(init_keys[0], n_steps)
    per_step = []
    lane_eps = torch.zeros((batch_size,), dtype=_I32, device=device)
    lane_rets = env.zero_rewards(batch_size, device)
    for s in range(n_steps):
        actions = policy(step_keys[s], eps)
        eps, outs = ma_episode_step(env, eps, actions)
        per_step.append({
            "episodes": outs.step.game_over.sum(dtype=_I32),
            "sum_final_returns": outs.final_returns.sum(dim=0),
        })
        if lane_stats:
            lane_eps = lane_eps + outs.step.game_over.to(_I32)
            lane_rets = lane_rets + outs.final_returns
    stats = sum_steps(per_step)
    if lane_stats:
        stats["lane_episodes"] = lane_eps
        stats["lane_final_returns"] = lane_rets
    return eps, stats

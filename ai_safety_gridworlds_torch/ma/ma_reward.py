"""Per-agent reward containers (multi-agent rewards).

Port of ``ai_safety_gridworlds_tpu/ma/ma_reward.py``, which is pure
Python: a dict of agent key -> :class:`mo_reward` with the same operator
algebra one level up (the in-place operators mutate only a value made with
``immutable=False``), and the helpers for enabled agents and dimensions
and the dense conversions.
"""

from __future__ import annotations

import numpy as np

from ai_safety_gridworlds_torch.mo.mo_reward import mo_reward


def _is_scalar(x) -> bool:
    return np.isscalar(x)


class ma_reward:
    """dict agent → mo_reward, with operator algebra."""

    __slots__ = ("_agents", "_immutable")

    def __init__(self, agent_rewards_dict, immutable=True):
        self._agents = {
            k: (v if isinstance(v, mo_reward) else mo_reward({None: v}))
            for k, v in agent_rewards_dict.items()
        }
        self._immutable = immutable

    @property
    def _agent_rewards_dict(self):
        return self._agents

    def copy(self) -> "ma_reward":
        return ma_reward(
            {k: v.copy() for k, v in self._agents.items()}, immutable=False
        )

    def __eq__(self, other):
        if _is_scalar(other):
            return all(v == other for v in self._agents.values())
        if isinstance(other, ma_reward):
            return self._agents == other._agents
        return NotImplemented

    def iszero(self) -> bool:
        return all(v.iszero() for v in self._agents.values())

    def __getitem__(self, agent):
        return self._agents[agent]

    def get(self, agent, default=None):
        return self._agents.get(agent, default)

    # -- enabled helpers (``ma_reward.py:123-247``) --------------------------

    @staticmethod
    def get_enabled_agent_rewards_keys(enabled_ma_rewards):
        """dict agent → sorted nonzero reward dimension keys."""
        if enabled_ma_rewards is None:
            return [None]
        return {
            agent: mo_reward.get_enabled_reward_dimension_keys(rewards)
            for agent, rewards in enabled_ma_rewards.items()
        }

    @staticmethod
    def get_enabled_reward_unit_space(enabled_ma_rewards):
        """dict agent → [min unit vector, max unit vector]."""
        if enabled_ma_rewards is None:
            return None
        return {
            agent: mo_reward.get_enabled_reward_unit_space(rewards)
            for agent, rewards in enabled_ma_rewards.items()
        }

    def tolist(self, enabled_ma_rewards):
        """dict agent → dense per-dimension list (or scalar sum)."""
        if enabled_ma_rewards is None:
            return {
                agent: reward.tolist(None)
                for agent, reward in self._agents.items()
            }
        out = {}
        for agent, enabled in enabled_ma_rewards.items():
            reward = self._agents.get(agent, mo_reward({}))
            out[agent] = reward.tolist(enabled)
        return out

    def tofull(self, enabled_ma_rewards):
        """dict agent → dense dict over enabled dims."""
        if enabled_ma_rewards is None:
            return {
                agent: reward.tofull(None)
                for agent, reward in self._agents.items()
            }
        out = {}
        for agent, enabled in enabled_ma_rewards.items():
            reward = self._agents.get(agent, mo_reward({}))
            out[agent] = reward.tofull(enabled)
        return out

    def __str__(self):
        return str({k: str(v) for k, v in self._agents.items()})

    def __repr__(self):
        return "<" + repr({k: repr(v) for k, v in self._agents.items()}) + ">"

    # -- algebra (``ma_reward.py:250-427``) ----------------------------------

    def _binary(self, other, op):
        if _is_scalar(other):
            return ma_reward(
                {k: op(v, other) for k, v in self._agents.items()},
                immutable=False,
            )
        if isinstance(other, ma_reward):
            out = {k: v.copy() for k, v in self._agents.items()}
            for k, v in other._agents.items():
                if k in out:
                    out[k] = op(out[k], v)
                else:
                    out[k] = op(mo_reward({}), v)
            return ma_reward(out, immutable=False)
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self + other

    def __iadd__(self, other):
        if self._immutable:
            return self.__add__(other)
        if _is_scalar(other):
            for k in self._agents:
                self._agents[k] += other
        elif isinstance(other, ma_reward):
            for k, v in other._agents.items():
                self._agents[k] = self._agents.get(k, mo_reward({})) + v
        else:
            return NotImplemented
        return self

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        if _is_scalar(other):
            return ma_reward(
                {k: other - v for k, v in self._agents.items()},
                immutable=False,
            )
        return NotImplemented

    def __neg__(self):
        return ma_reward(
            {k: -v for k, v in self._agents.items()}, immutable=False
        )

    def __mul__(self, other):
        if not _is_scalar(other):
            raise NotImplementedError("ma_reward.__mul__ expects a scalar")
        return ma_reward(
            {k: v * other for k, v in self._agents.items()}, immutable=False
        )

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if not _is_scalar(other):
            raise NotImplementedError("ma_reward.__truediv__ expects a scalar")
        return ma_reward(
            {k: v / other for k, v in self._agents.items()}, immutable=False
        )

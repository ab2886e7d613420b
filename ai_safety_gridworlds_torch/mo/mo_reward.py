"""Named-dimension reward values and their dense encoding.

Port of the parts of ``ai_safety_gridworlds_tpu/mo/mo_reward.py`` that the
fused kernels read: the ``mo_reward`` value type (construction, flag
parsing, equality, the enabled-dimension helpers) and
:class:`MoRewardSpace`, which turns each reward constant into a dense
float32 vector. The operator algebra waits for the stateful-shell slice.
"""

from __future__ import annotations

from ast import literal_eval

import numpy as np


class mo_reward:
    """A named-dimension reward value."""

    __slots__ = ("_dims", "_immutable")

    def __init__(self, reward_dimensions_dict, immutable=True):
        self._dims = dict(reward_dimensions_dict)
        self._immutable = immutable

    @property
    def _reward_dimensions_dict(self):
        return self._dims

    def __eq__(self, other):
        if np.isscalar(other):
            return all(v == other for v in self._dims.values())
        if isinstance(other, mo_reward):
            return self._dims == other._dims
        return NotImplemented

    def __hash__(self):
        return hash(frozenset(self._dims.items()))

    def iszero(self) -> bool:
        return all(v == 0 for v in self._dims.values())

    @staticmethod
    def parse(string: str) -> "mo_reward":
        """Parse a python-dict-literal string flag."""
        if string == "":
            return mo_reward({})
        return mo_reward(literal_eval(string))

    @staticmethod
    def get_enabled_reward_dimension_keys(enabled_mo_rewards):
        """Sorted union of nonzero dimension keys."""
        if not enabled_mo_rewards:
            return [None]
        keys = set()
        for reward in enabled_mo_rewards:
            keys |= {k for k, v in reward._dims.items() if v != 0}
        return sorted(keys)

    @staticmethod
    def get_enabled_reward_unit_space(enabled_mo_rewards):
        """[min unit vector, max unit vector] over the enabled dims."""
        if not enabled_mo_rewards:
            return None
        keys = mo_reward.get_enabled_reward_dimension_keys(enabled_mo_rewards)
        mins = [
            min(r._dims.get(k, 0) for r in enabled_mo_rewards) for k in keys
        ]
        maxs = [
            max(r._dims.get(k, 0) for r in enabled_mo_rewards) for k in keys
        ]
        return [mins, maxs]

    def __str__(self):
        return str({k: v for k, v in self._dims.items() if v != 0})

    def __repr__(self):
        return "<" + repr({k: v for k, v in self._dims.items() if v != 0}) + ">"


class MoRewardSpace:
    """Compile-time dense encoding of an enabled-rewards list."""

    def __init__(self, enabled_mo_rewards, scalarise: bool = False):
        self.enabled = enabled_mo_rewards
        self.scalarise = scalarise
        self.keys = mo_reward.get_enabled_reward_dimension_keys(
            enabled_mo_rewards
        )
        self.n_dims = len(self.keys) if self.keys != [None] else 1
        self._index = {k: i for i, k in enumerate(self.keys)}

    def vector(self, reward: mo_reward) -> np.ndarray:
        """Dense f32 vector (or 1-dim scalarised sum) of a reward constant."""
        if self.scalarise or self.keys == [None]:
            return np.asarray([sum(reward._dims.values())], dtype=np.float32)
        out = np.zeros((self.n_dims,), dtype=np.float32)
        for k, v in reward._dims.items():
            if v != 0:
                if k not in self._index:
                    raise ValueError(f"Reward {k} is not enabled")
                out[self._index[k]] = v
        return out

    def zero(self) -> np.ndarray:
        return np.zeros((self.n_dims,), dtype=np.float32)

    def unit_space(self):
        return mo_reward.get_enabled_reward_unit_space(self.enabled)

"""Named-dimension reward values and their dense encoding.

Port of ``ai_safety_gridworlds_tpu/mo/mo_reward.py``, which is pure
Python and numpy: the ``mo_reward`` value type (a dict of named reward
dimensions with the reference's operator algebra, elementwise and
list-wise max/min, dense conversion and flag parsing; the in-place
operators mutate only a reward made with ``immutable=False``, and return
a new value otherwise) and :class:`MoRewardSpace`, which turns each reward
constant into the dense float32 vector the kernels and the generic chains
read.
"""

from __future__ import annotations

from ast import literal_eval

import numpy as np


def _is_scalar(x) -> bool:
    return np.isscalar(x)


class mo_reward:
    """A named-dimension reward value. Same observable semantics as the
    reference class of the same name."""

    __slots__ = ("_dims", "_immutable")

    def __init__(self, reward_dimensions_dict, immutable=True):
        self._dims = dict(reward_dimensions_dict)
        self._immutable = immutable

    # Keep the reference's private-attribute name readable for code that
    # pokes at it (some reference tests/utilities do).
    @property
    def _reward_dimensions_dict(self):
        return self._dims

    def copy(self) -> "mo_reward":
        return mo_reward(dict(self._dims), immutable=False)

    def __eq__(self, other):
        if _is_scalar(other):
            return all(v == other for v in self._dims.values())
        if isinstance(other, mo_reward):
            return self._dims == other._dims
        return NotImplemented

    def __hash__(self):
        return hash(frozenset(self._dims.items()))

    def iszero(self) -> bool:
        return all(v == 0 for v in self._dims.values())

    # -- elementwise max/min (instance flavour keyed against 0 defaults,
    #    ``mo_reward.py:55-88``); the reference later shadows these with
    #    static list-reducing versions, which we expose as max_of/min_of.

    def elem_max(self, other) -> "mo_reward":
        if _is_scalar(other):
            return mo_reward(
                {k: max(v, other) for k, v in self._dims.items()},
                immutable=False,
            )
        if isinstance(other, mo_reward):
            out = {k: max(v, 0) for k, v in self._dims.items()}
            for k, v in other._dims.items():
                out[k] = max(v, out.get(k, 0))
            return mo_reward(out, immutable=False)
        raise NotImplementedError(
            "Expecting a scalar or mo_reward for elem_max"
        )

    def elem_min(self, other) -> "mo_reward":
        if _is_scalar(other):
            return mo_reward(
                {k: min(v, other) for k, v in self._dims.items()},
                immutable=False,
            )
        if isinstance(other, mo_reward):
            out = {k: min(v, 0) for k, v in self._dims.items()}
            for k, v in other._dims.items():
                out[k] = min(v, out.get(k, 0))
            return mo_reward(out, immutable=False)
        raise NotImplementedError(
            "Expecting a scalar or mo_reward for elem_min"
        )

    @staticmethod
    def max(rewards_list):
        """Dimension-wise max over a list (``mo_reward.py:91-97``)."""
        result = mo_reward({})
        for reward in rewards_list:
            result = result.elem_max(reward)
        return result

    @staticmethod
    def min(rewards_list):
        """Dimension-wise min over a list (``mo_reward.py:100-106``)."""
        result = mo_reward({})
        for reward in rewards_list:
            result = result.elem_min(reward)
        return result

    @staticmethod
    def parse(string: str) -> "mo_reward":
        """Parse a python-dict-literal string flag (``mo_reward.py:109-117``)."""
        if string == "":
            return mo_reward({})
        return mo_reward(literal_eval(string))

    # -- enabled-dimension helpers ------------------------------------------

    @staticmethod
    def get_enabled_reward_dimension_keys(enabled_mo_rewards):
        """Sorted union of nonzero dimension keys (``mo_reward.py:121-146``)."""
        if not enabled_mo_rewards:
            return [None]
        keys = set()
        for reward in enabled_mo_rewards:
            keys |= {k for k, v in reward._dims.items() if v != 0}
        return sorted(keys)

    @staticmethod
    def get_enabled_reward_unit_space(enabled_mo_rewards):
        """[min unit vector, max unit vector] (``mo_reward.py:150-181``)."""
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

    def tolist(self, enabled_mo_rewards):
        """Dense list over enabled dims; scalar sum when scalarising
        (``mo_reward.py:184-203``)."""
        if enabled_mo_rewards is None:
            return sum(self._dims.values())
        keys = mo_reward.get_enabled_reward_dimension_keys(enabled_mo_rewards)
        for k, v in self._dims.items():
            if v != 0 and k not in keys:
                raise ValueError(
                    f"Reward {k} is not enabled but is still included in "
                    "mo_reward with nonzero value"
                )
        return [self._dims.get(k, 0) for k in keys]

    def tofull(self, enabled_mo_rewards):
        """Dense dict over enabled dims (``mo_reward.py:206-225``)."""
        if enabled_mo_rewards is None:
            return {None: sum(self._dims.values())}
        keys = mo_reward.get_enabled_reward_dimension_keys(enabled_mo_rewards)
        for k, v in self._dims.items():
            if v != 0 and k not in keys:
                raise ValueError(
                    f"Reward {k} is not enabled but is still included in "
                    "mo_reward with nonzero value"
                )
        return {k: self._dims.get(k, 0) for k in keys}

    def __str__(self):
        return str({k: v for k, v in self._dims.items() if v != 0})

    def __repr__(self):
        return "<" + repr({k: v for k, v in self._dims.items() if v != 0}) + ">"

    # -- operator algebra (``mo_reward.py:248-398``) -------------------------

    def __add__(self, other):
        if _is_scalar(other):
            return mo_reward(
                {k: v + other for k, v in self._dims.items()}, immutable=False
            )
        if isinstance(other, mo_reward):
            out = dict(self._dims)
            for k, v in other._dims.items():
                out[k] = out.get(k, 0) + v
            return mo_reward(out, immutable=False)
        return NotImplemented

    def __iadd__(self, other):
        if self._immutable:
            return self.__add__(other)
        if _is_scalar(other):
            for k in self._dims:
                self._dims[k] += other
        elif isinstance(other, mo_reward):
            for k, v in other._dims.items():
                self._dims[k] = self._dims.get(k, 0) + v
        else:
            return NotImplemented
        return self

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        if _is_scalar(other):
            return mo_reward(
                {k: v - other for k, v in self._dims.items()}, immutable=False
            )
        if isinstance(other, mo_reward):
            out = dict(self._dims)
            for k, v in other._dims.items():
                out[k] = out.get(k, 0) - v
            return mo_reward(out, immutable=False)
        return NotImplemented

    def __isub__(self, other):
        if self._immutable:
            return self.__sub__(other)
        if _is_scalar(other):
            for k in self._dims:
                self._dims[k] -= other
        elif isinstance(other, mo_reward):
            for k, v in other._dims.items():
                self._dims[k] = self._dims.get(k, 0) - v
        else:
            return NotImplemented
        return self

    def __rsub__(self, other):
        if _is_scalar(other):
            return mo_reward(
                {k: other - v for k, v in self._dims.items()}, immutable=False
            )
        if isinstance(other, mo_reward):
            out = dict(self._dims)
            for k, v in other._dims.items():
                out[k] = v - out.get(k, 0)
            return mo_reward(out, immutable=False)
        return NotImplemented

    def __neg__(self):
        return mo_reward(
            {k: -v for k, v in self._dims.items()}, immutable=False
        )

    def __mul__(self, other):
        if not _is_scalar(other):
            raise NotImplementedError("mo_reward.__mul__ expects a scalar")
        return mo_reward(
            {k: v * other for k, v in self._dims.items()}, immutable=False
        )

    def __imul__(self, other):
        if self._immutable:
            return self.__mul__(other)
        if not _is_scalar(other):
            raise NotImplementedError("mo_reward.__imul__ expects a scalar")
        for k in self._dims:
            self._dims[k] *= other
        return self

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if not _is_scalar(other):
            raise NotImplementedError("mo_reward.__truediv__ expects a scalar")
        return mo_reward(
            {k: v / other for k, v in self._dims.items()}, immutable=False
        )

    def __itruediv__(self, other):
        if self._immutable:
            return self.__truediv__(other)
        if not _is_scalar(other):
            raise NotImplementedError("mo_reward.__itruediv__ expects a scalar")
        for k in self._dims:
            self._dims[k] /= other
        return self

    def __rtruediv__(self, other):
        if not _is_scalar(other):
            raise NotImplementedError("mo_reward.__rtruediv__ expects a scalar")
        return mo_reward(
            {k: other / v for k, v in self._dims.items()}, immutable=False
        )


class MoRewardSpace:
    """Compile-time dense encoding of an enabled-rewards list.

    The reference re-derives the sorted key union on every conversion
    (``mo_reward.py:121-203``); here it is computed once, and every reward
    constant becomes a dense float vector the kernels use directly.
    """

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
            return np.asarray(
                [sum(reward._dims.values())], dtype=np.float32
            )
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

"""dm_env-style RL API types.

Port of ``ai_safety_gridworlds_tpu/core/timestep.py``: the step-type and
termination-reason enums, the ``TimeStep`` of a transition, the array
specs of the stateful shell (``ArraySpec``, ``BoundedArraySpec``) and
``observation_spec_of``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional

import numpy as np


class StepType(enum.IntEnum):
    """FIRST/MID/LAST, plus DEAD for agents already terminated in an
    ongoing multi-agent episode."""

    FIRST = 0
    MID = 1
    LAST = 2
    DEAD = 3

    def first(self) -> bool:
        return self is StepType.FIRST

    def mid(self) -> bool:
        return self is StepType.MID

    def last(self) -> bool:
        return self is StepType.LAST

    def dead(self) -> bool:
        return self is StepType.DEAD


class TerminationReason(enum.IntEnum):
    TERMINATED = 0
    MAX_STEPS = 1
    INTERRUPTED = 2
    QUIT = 3
    # Sentinel meaning "no termination recorded yet"; never surfaced to users.
    NONE = -1


@dataclasses.dataclass
class TimeStep:
    """A single transition: ``step_type`` int32 (or per agent),
    ``reward`` float32 (scalar, per dim or per agent), ``discount``
    float32 and the observation dict; ``reward``/``discount`` on FIRST
    steps are 0/1 placeholders, which the stateful shell turns into
    ``None``."""

    step_type: Any
    reward: Any
    discount: Any
    observation: Any

    def first(self):
        return self.step_type == StepType.FIRST

    def mid(self):
        return self.step_type == StepType.MID

    def last(self):
        return self.step_type == StepType.LAST


class ArraySpec:
    """Describes the shape and dtype of an array."""

    __slots__ = ("shape", "dtype", "name")

    def __init__(self, shape, dtype, name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.name = name

    def __repr__(self):
        return (f"ArraySpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name!r})")

    def __eq__(self, other):
        if not isinstance(other, ArraySpec):
            return NotImplemented
        return self.shape == other.shape and self.dtype == other.dtype

    def validate(self, value):
        value = np.asarray(value)
        if value.shape != self.shape:
            raise ValueError(
                f"Expected shape {self.shape} but found {value.shape}"
            )
        if value.dtype != self.dtype:
            raise ValueError(
                f"Expected dtype {self.dtype} but found {value.dtype}"
            )
        return value

    def generate_value(self):
        return np.zeros(self.shape, dtype=self.dtype)


class BoundedArraySpec(ArraySpec):
    """An :class:`ArraySpec` with inclusive bounds that broadcast to it."""

    __slots__ = ("minimum", "maximum")

    def __init__(self, shape, dtype, minimum, maximum, name=None):
        super().__init__(shape, dtype, name)
        self.minimum = np.array(minimum)
        self.maximum = np.array(maximum)
        if (self.minimum.shape not in ((), self.shape)
                or self.maximum.shape not in ((), self.shape)):
            raise ValueError("minimum/maximum must broadcast to shape")

    def __repr__(self):
        return (
            f"BoundedArraySpec(shape={self.shape}, dtype={self.dtype}, "
            f"minimum={self.minimum}, maximum={self.maximum}, "
            f"name={self.name!r})"
        )

    def __eq__(self, other):
        if not isinstance(other, BoundedArraySpec):
            return NotImplemented
        return (
            super().__eq__(other)
            and np.all(self.minimum == other.minimum)
            and np.all(self.maximum == other.maximum)
        )

    def validate(self, value):
        value = super().validate(value)
        if np.any(value < self.minimum) or np.any(value > self.maximum):
            raise ValueError(
                f"Values out of bounds [{self.minimum}, {self.maximum}]"
            )
        return value

    def generate_value(self):
        return np.full(self.shape, self.minimum, dtype=self.dtype)


def observation_spec_of(observation: Mapping[str, Any]) -> dict:
    """A dict of ArraySpecs from an example observation dict."""
    spec = {}
    for key, value in observation.items():
        if isinstance(value, Mapping):
            spec[key] = observation_spec_of(value)
        else:
            arr = np.asarray(value)
            spec[key] = ArraySpec(arr.shape, arr.dtype, name=key)
    return spec

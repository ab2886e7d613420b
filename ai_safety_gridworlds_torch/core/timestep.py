"""Step-type and termination-reason enums.

Port of the enums of ``ai_safety_gridworlds_tpu/core/timestep.py``; the
``TimeStep`` and spec types wait for the stateful-shell slice.
"""

from __future__ import annotations

import enum


class StepType(enum.IntEnum):
    """FIRST/MID/LAST, plus DEAD for agents already terminated in an
    ongoing multi-agent episode."""

    FIRST = 0
    MID = 1
    LAST = 2
    DEAD = 3


class TerminationReason(enum.IntEnum):
    TERMINATED = 0
    MAX_STEPS = 1
    INTERRUPTED = 2
    QUIT = 3
    # Sentinel meaning "no termination recorded yet"; never surfaced to users.
    NONE = -1

"""Action and direction enums and the dense direction tables.

Port of ``ai_safety_gridworlds_tpu/core/actions.py``: the enums and the
numpy tables the fused kernels read. All direction tables are
``[action_id 0..9, Directions 0..3] -> Directions``.
"""

from __future__ import annotations

import enum

import numpy as np


class Actions(enum.IntEnum):
    """Actions of the original (scalar) safety suite."""

    NOOP = 0
    UP = 1
    DOWN = 2
    LEFT = 3
    RIGHT = 4
    QUIT = 9


class ActionsMo(enum.IntEnum):
    """Actions of the extended multi-objective suite."""

    NOOP = 0
    LEFT = 1
    RIGHT = 2
    UP = 3
    DOWN = 4
    TURN_LEFT_90 = 5
    TURN_RIGHT_90 = 6
    TURN_LEFT_180 = 7
    TURN_RIGHT_180 = 8
    QUIT = 9


class Directions(enum.IntEnum):
    LEFT = 0
    RIGHT = 1
    UP = 2
    DOWN = 3


N_ACTION_IDS = 10


def _delta_table(mapping: dict) -> np.ndarray:
    table = np.zeros((N_ACTION_IDS, 2), dtype=np.int32)
    for action_id, (dr, dc) in mapping.items():
        table[action_id] = (dr, dc)
    return table


# (row, col) displacement per action id; rows grow downward.
ACTION_DELTAS = _delta_table({
    int(Actions.UP): (-1, 0),
    int(Actions.DOWN): (1, 0),
    int(Actions.LEFT): (0, -1),
    int(Actions.RIGHT): (0, 1),
})
ACTION_DELTAS_MO = _delta_table({
    int(ActionsMo.UP): (-1, 0),
    int(ActionsMo.DOWN): (1, 0),
    int(ActionsMo.LEFT): (0, -1),
    int(ActionsMo.RIGHT): (0, 1),
})

_L, _R, _U, _D = (int(d) for d in Directions)


def _identity_dir_table() -> np.ndarray:
    return np.tile(np.arange(4, dtype=np.int32), (N_ACTION_IDS, 1))


def _build_rel_move_dir_table() -> np.ndarray:
    """Mode 1: the facing after a relative move (UP keeps, DOWN flips,
    LEFT/RIGHT rotate); every other action keeps the facing."""
    t = _identity_dir_table()
    down, left, right = (
        int(ActionsMo.DOWN), int(ActionsMo.LEFT), int(ActionsMo.RIGHT)
    )
    t[down, [_U, _D, _L, _R]] = [_D, _U, _R, _L]
    t[left, [_U, _D, _L, _R]] = [_L, _R, _D, _U]
    t[right, [_U, _D, _L, _R]] = [_R, _L, _U, _D]
    return t


def _build_rel_turn_dir_table() -> np.ndarray:
    """Mode 2: the facing after a TURN_* action; moves and NOOP keep it."""
    t = _identity_dir_table()
    t[int(ActionsMo.TURN_LEFT_90), [_U, _D, _L, _R]] = [_L, _R, _D, _U]
    t[int(ActionsMo.TURN_RIGHT_90), [_U, _D, _L, _R]] = [_R, _L, _U, _D]
    for a in (ActionsMo.TURN_LEFT_180, ActionsMo.TURN_RIGHT_180):
        t[int(a), [_U, _D, _L, _R]] = [_D, _U, _R, _L]
    return t


REL_MOVE_DIR = _build_rel_move_dir_table()
REL_TURN_DIR = _build_rel_turn_dir_table()

# Absolute move action (ActionsMo id) per Directions id.
DIR_TO_ACTION_MO = np.array(
    [int(ActionsMo.LEFT), int(ActionsMo.RIGHT), int(ActionsMo.UP),
     int(ActionsMo.DOWN)],
    np.int32,
)

# Action-direction update table per mode: MODE_DIR_TABLES[mode][action, dir].
# Mode 0 (fixed) keeps the direction for every action.
MODE_DIR_TABLES = (_identity_dir_table(), REL_MOVE_DIR, REL_TURN_DIR)

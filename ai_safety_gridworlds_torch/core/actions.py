"""Action and direction enums and the dense direction tables.

Port of ``ai_safety_gridworlds_tpu/core/actions.py``: the enums, the
numpy tables the fused kernels read, and the direction functions of the
generic path on ``[B]`` tensors. All direction tables are
``[action_id 0..9, Directions 0..3] -> Directions``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


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

# Direction unit vectors indexed by Directions id (LEFT, RIGHT, UP, DOWN).
DIRECTION_DELTAS = np.array([(0, -1), (0, 1), (-1, 0), (1, 0)], dtype=np.int32)

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


_TABLES = {0: MODE_DIR_TABLES[0], 1: MODE_DIR_TABLES[1],
           2: MODE_DIR_TABLES[2], "turn": REL_TURN_DIR,
           "dir_to_action": DIR_TO_ACTION_MO}
# The tables as tensors, made once per device: a host-to-device copy in
# every step would wait for the card's queue.
_device_tables: dict = {}


def _table(name, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _device_tables:
        _device_tables[key] = torch.as_tensor(_TABLES[name], device=device)
    return _device_tables[key]


def _dir_lookup(table_name, proposed, current):
    p = proposed.to(torch.int64).clamp(0, N_ACTION_IDS - 1)
    return _table(table_name, proposed.device)[p, current.to(torch.int64)]


def new_action_direction(proposed, current, mode: int):
    """New facing after an action (``[B]`` int32): ``proposed`` is the
    ``action_direction`` entry when given, else the step action. NOOP
    keeps the facing in every mode."""
    return _dir_lookup(mode, proposed, current)


def new_observation_direction(
    proposed, current, action_direction_mode: int,
    observation_direction_mode: int,
):
    """New observation facing (``[B]`` int32). In observation mode 1 the
    relative mapping consults the ACTION direction mode: a fixed action
    mode leaves the observation facing unchanged, as in the reference."""
    odm = observation_direction_mode
    if odm == 0:
        return current.to(torch.int32)
    if odm == 1:
        mode = 1 if action_direction_mode in (1, 2) else 0
        return _dir_lookup(mode, proposed, current)
    if odm == 2:
        if action_direction_mode == 0:
            raise NotImplementedError(
                "observation mode 2 with fixed action mode"
            )
        return _dir_lookup("turn", proposed, current)
    raise ValueError("observation_direction_mode")


def absolute_move_action(step_action, action_direction, mode: int):
    """The absolute move executed for a relative step action (``[B]``
    int32): in modes 1/2 a LEFT/RIGHT/UP/DOWN step moves relative to the
    current facing; turns and NOOP pass through (and move nothing)."""
    a = step_action.to(torch.int32)
    if mode == 0:
        return a
    is_move = (a >= int(ActionsMo.LEFT)) & (a <= int(ActionsMo.DOWN))
    rel = _dir_lookup(1, a, action_direction)
    return torch.where(
        is_move, _table("dir_to_action", a.device)[rel.to(torch.int64)], a
    )

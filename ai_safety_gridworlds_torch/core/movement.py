"""MazeWalker-style movement on a batch of lanes.

Port of ``ai_safety_gridworlds_tpu/core/movement.py``, written for a
leading batch dim instead of ``jax.vmap``: positions are ``[B, 2]`` int32
(row, col), and a board or mask is either one static ``[H, W]`` grid
shared by every lane or a ``[B, H, W]`` grid per lane.

* :func:`attempt_move` / :func:`attempt_move_masked`: a cardinal move is
  legal when its target lies on the board and is not impassable there
  (the rendered board through an impassable-char table, or a precomputed
  blocked mask);
* :func:`maze_walker_move`: the eight motions with the diagonal corner rule
  (a diagonal is blocked by its own corner cell or by BOTH flanking cells)
  and off-board "virtual" positions for an unconfined walker, where every
  off-board cell reads as the EDGE sentinel that blocks only confined
  walkers.
"""

from __future__ import annotations

import numpy as np
import torch

# Eight single-step motions + stay, indexed 0..8: N, NE, E, SE, S, SW, W,
# NW, STAY.
MOTIONS_8 = np.array(
    [
        (-1, 0), (-1, 1), (0, 1), (1, 1),
        (1, 0), (1, -1), (0, -1), (-1, -1),
        (0, 0),
    ],
    dtype=np.int32,
)


# MOTIONS_8 as a tensor, made once per device (a copy per call would wait
# for the card's queue).
_motions: dict = {}


def at(grid: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """``grid[r, c]`` per lane: ``grid`` is ``[H, W]`` (shared) or
    ``[B, H, W]`` (per lane); ``rows``/``cols`` are ``[B]`` in range."""
    r, c = rows.to(torch.int64), cols.to(torch.int64)
    if grid.dim() == 2:
        return grid[r, c]
    return grid[torch.arange(grid.shape[0], device=grid.device), r, c]


def _in_bounds(target, h, w):
    return (
        (target[:, 0] >= 0) & (target[:, 0] < h)
        & (target[:, 1] >= 0) & (target[:, 1] < w)
    )


def attempt_move(pos, delta, board, impassable_lut, confined=True):
    """Move each lane by ``delta`` where legal; returns (new_pos [B, 2],
    moved [B]). Legality reads the rendered ``board`` (uint8 char codes)
    through ``impassable_lut`` (bool [256])."""
    h, w = board.shape[-2:]
    target = pos + delta
    in_bounds = _in_bounds(target, h, w)
    tr = target[:, 0].clamp(0, h - 1)
    tc = target[:, 1].clamp(0, w - 1)
    blocked = impassable_lut[at(board, tr, tc).to(torch.int64)]
    legal = in_bounds & ~blocked
    if not confined:
        legal = legal | ~in_bounds
    return torch.where(legal[:, None], target, pos), legal


def attempt_move_masked(pos, delta, blocked, confined=True):
    """Like :func:`attempt_move` with a precomputed bool blocked mask."""
    h, w = blocked.shape[-2:]
    target = pos + delta
    in_bounds = _in_bounds(target, h, w)
    tr = target[:, 0].clamp(0, h - 1)
    tc = target[:, 1].clamp(0, w - 1)
    legal = in_bounds & ~at(blocked, tr, tc)
    if not confined:
        legal = legal | ~in_bounds
    return torch.where(legal[:, None], target, pos), legal


def _cell_impassable(pos, board, impassable_lut, confined):
    h, w = board.shape[-2:]
    on_board = _in_bounds(pos, h, w)
    rr = pos[:, 0].clamp(0, h - 1)
    cc = pos[:, 1].clamp(0, w - 1)
    char_blocks = impassable_lut[at(board, rr, cc).to(torch.int64)]
    if confined:
        return ~on_board | (on_board & char_blocks)
    return on_board & char_blocks


def maze_walker_move(pos, motion_id, board, impassable_lut, confined=True):
    """Full MazeWalker motion for each lane: ``motion_id`` [B] indexes
    :data:`MOTIONS_8` (8 = stay, which always succeeds). Returns
    (new_pos [B, 2], moved [B])."""
    key = str(pos.device)
    if key not in _motions:
        _motions[key] = torch.as_tensor(MOTIONS_8, device=pos.device)
    delta = _motions[key][motion_id.to(torch.int64).clamp(0, 8)]
    target = pos + delta
    target_blocked = _cell_impassable(target, board, impassable_lut, confined)
    zero = torch.zeros_like(delta[:, 0])
    row_side = pos + torch.stack([delta[:, 0], zero], dim=1)
    col_side = pos + torch.stack([zero, delta[:, 1]], dim=1)
    row_blocked = _cell_impassable(row_side, board, impassable_lut, confined)
    col_blocked = _cell_impassable(col_side, board, impassable_lut, confined)
    is_diag = (delta[:, 0] != 0) & (delta[:, 1] != 0)
    is_stay = (delta[:, 0] == 0) & (delta[:, 1] == 0)
    blocked = torch.where(
        is_diag, target_blocked | (row_blocked & col_blocked), target_blocked
    )
    legal = is_stay | ~blocked
    return torch.where(legal[:, None], target, pos), legal


def is_on_board(pos, shape) -> torch.Tensor:
    """Whether each lane's virtual position is on the board."""
    h, w = shape
    return _in_bounds(pos, h, w)

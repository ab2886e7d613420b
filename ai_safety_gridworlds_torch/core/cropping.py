"""Observation croppers: fixed and scrolling windows over char boards.

Port of ``ai_safety_gridworlds_tpu/core/cropping.py`` (pycolab's
observation post-processors, ``pycolab/cropping.py:30-598``): a cropper
takes one rendered ``[H, W]`` board and returns a fixed-size window.
``FixedCropper`` cuts a static region; ``ScrollingCropper`` pans the window
to keep a tracked entity in view with scroll margins and optional saccades.

These are host-side display helpers on one board at a time (a shell's
observation, a lane of a batch). A board may be a numpy array or a tensor
on any device: the window is cut where the board lies, as a pad and a
slice, so a board on the card comes back to the host once per crop (the
window), never once per cell. The scrolling state is an explicit
``(row, col)`` corner of Python ints that the caller threads through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _as_tensor(board):
    """``board`` as a tensor (numpy shares its memory) and whether it came
    as numpy."""
    if isinstance(board, torch.Tensor):
        return board, False
    return torch.from_numpy(np.ascontiguousarray(board)), True


def _to_host(window: torch.Tensor) -> np.ndarray:
    return window.cpu().numpy()


class ObservationCropper:
    """Base cropper: pass the observation through unchanged
    (``cropping.py:30-107``)."""

    def crop(self, board, **kwargs):
        return board

    @property
    def rows(self):
        return None

    @property
    def cols(self):
        return None


def _pad_and_slice(board, top, left, rows, cols, pad_value):
    """``board[top:top+rows, left:left+cols]`` of a ``[H, W]`` tensor with
    out-of-bounds cells ``pad_value``: the board padded by ``(rows, cols)``
    on every side, then sliced, as JAX's pad and ``dynamic_slice`` (a
    corner further out than the window's size clamps onto the padding's
    edge, as ``dynamic_slice`` clamps)."""
    h, w = board.shape
    padded = torch.full((h + 2 * rows, w + 2 * cols), pad_value,
                        dtype=board.dtype, device=board.device)
    padded[rows:rows + h, cols:cols + w] = board
    r0 = min(max(int(top) + rows, 0), h + rows)
    c0 = min(max(int(left) + cols, 0), w + cols)
    return padded[r0:r0 + rows, c0:c0 + cols]


class FixedCropper(ObservationCropper):
    """Static window at ``top_left_corner`` of size ``rows x cols``
    (``cropping.py:230-268``). Without ``pad_char`` the window must lie
    entirely on the board. The window is a tensor on the board's device
    for a tensor board, a numpy array for a numpy board."""

    def __init__(
        self,
        top_left_corner: Tuple[int, int],
        rows: int,
        cols: int,
        pad_char: Optional[str] = None,
    ):
        self._top_left = tuple(top_left_corner)
        self._rows = int(rows)
        self._cols = int(cols)
        self._pad = None if pad_char is None else ord(pad_char)

    @property
    def rows(self):
        return self._rows

    @property
    def cols(self):
        return self._cols

    def crop(self, board, **kwargs):
        board, was_numpy = _as_tensor(board)
        h, w = board.shape
        top, left = self._top_left
        if self._pad is None:
            if (
                top < 0
                or left < 0
                or top + self._rows > h
                or left + self._cols > w
            ):
                raise ValueError(
                    "FixedCropper window exceeds the board and no pad_char "
                    "was given"
                )
            out = board[top:top + self._rows, left:left + self._cols]
        else:
            # The exact overlap of a static corner (a window further off
            # the board than its own size is all padding).
            out = torch.full((self._rows, self._cols), self._pad,
                             dtype=board.dtype, device=board.device)
            t0, l0 = max(top, 0), max(left, 0)
            t1 = min(top + self._rows, int(h))
            l1 = min(left + self._cols, int(w))
            if t1 > t0 and l1 > l0:
                out[t0 - top:t1 - top, l0 - left:l1 - left] = \
                    board[t0:t1, l0:l1]
        return _to_host(out) if was_numpy else out


class ScrollingCropper(ObservationCropper):
    """Egocentric window tracking an entity (``cropping.py:271-…``).

    The caller passes the tracked position and threads the window corner
    through:

        corner = cropper.initial_corner(position, board_shape)
        window, corner = cropper.crop(board, position=pos, corner=corner)

    The window scrolls just enough to keep the entity ``scroll_margins``
    away from the edge; ``None`` margins centre the entity (the window dim
    must be odd); with ``saccade`` the window jumps to centre when the
    entity is more than one step out of bounds. The window comes back as a
    numpy array, the corner as Python ints.
    """

    def __init__(
        self,
        rows: int,
        cols: int,
        pad_char: Optional[str] = None,
        scroll_margins: Tuple[Optional[int], Optional[int]] = (2, 3),
        saccade: bool = True,
        initial_offset: Optional[Tuple[int, int]] = None,
    ):
        self._rows = int(rows)
        self._cols = int(cols)
        # The first window is shifted so the tracked entity sits this far
        # from the centre (used by better_scrolly_maze).
        self._initial_offset = initial_offset
        self._pad = None if pad_char is None else ord(pad_char)
        mr, mc = scroll_margins
        if mr is None and rows % 2 == 0:
            raise ValueError("centred tracking requires odd rows")
        if mc is None and cols % 2 == 0:
            raise ValueError("centred tracking requires odd cols")
        self._margin_r = rows // 2 if mr is None else int(mr)
        self._margin_c = cols // 2 if mc is None else int(mc)
        if 2 * self._margin_r >= rows and mr is not None:
            raise ValueError("row scroll margins overlap")
        if 2 * self._margin_c >= cols and mc is not None:
            raise ValueError("column scroll margins overlap")
        self._saccade = saccade

    @property
    def rows(self):
        return self._rows

    @property
    def cols(self):
        return self._cols

    def initial_corner(self, position, board_shape):
        """Centre the window on the tracked position, shifted by the
        optional ``initial_offset``."""
        dr, dc = self._initial_offset or (0, 0)
        top = int(position[0]) - self._rows // 2 + dr
        left = int(position[1]) - self._cols // 2 + dc
        return self._clamp(top, left, board_shape)

    def _clamp(self, top, left, board_shape):
        if self._pad is None:
            h, w = board_shape
            top = min(max(top, 0), max(0, h - self._rows))
            left = min(max(left, 0), max(0, w - self._cols))
        return (int(top), int(left))

    def _scroll_axis(self, pos, corner, size, margin):
        lo = corner + margin
        hi = corner + size - 1 - margin
        if pos < lo:
            shift = pos - lo
        elif pos > hi:
            shift = pos - hi
        else:
            shift = 0
        if abs(shift) > 1 and self._saccade:
            # Jump so the entity is centred (the saccade rule).
            return pos - size // 2
        elif abs(shift) > 1 and not self._saccade:
            return corner  # wait for the entity to wander back in bounds
        return corner + shift

    def crop(self, board, position=None, corner=None, **kwargs):
        board, _ = _as_tensor(board)
        if position is None:
            raise ValueError("ScrollingCropper.crop needs position=")
        shape = tuple(board.shape)
        if corner is None:
            corner = self.initial_corner(position, shape)
        top = self._scroll_axis(int(position[0]), corner[0], self._rows,
                                self._margin_r)
        left = self._scroll_axis(int(position[1]), corner[1], self._cols,
                                 self._margin_c)
        top, left = self._clamp(top, left, shape)
        pad = self._pad if self._pad is not None else 0
        window = _pad_and_slice(board, top, left, self._rows, self._cols,
                                pad)
        return _to_host(window), (top, left)

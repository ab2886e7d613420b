"""Functional scrolling-world machinery (the Scrolly-drape substrate).

Port of ``ai_safety_gridworlds_tpu/core/scrolling.py``. The reference's
egocentric scrolling stack keeps a huge static ``whole_pattern`` and
addresses board windows by an integer ORIGIN: scrolling moves the origin,
and the "teleportation" pattern rolls of ``t_maze`` become ``origin +=
shift`` with wraparound, the window read modulo the pattern shape.

JAX reads one lane's window with one ``dynamic_slice`` of a 2x2-tiled
pattern under ``vmap``; here every read takes ``[B, 2]`` origins and
gathers all lanes' windows at once from the same tiling (an origin taken
modulo the pattern plus a window no larger than the pattern stays inside
it). The tiled masks live once per device, made on first use.
"""

from __future__ import annotations

import numpy as np
import torch


class ScrollingWorld:
    """A static whole-pattern with a board-sized window addressed by origin.

    Args:
      pattern_masks: dict char -> bool [Hp, Wp] whole-pattern masks.
      board_shape: (h, w) of the game board (the window).
    """

    def __init__(self, pattern_masks: dict, board_shape):
        self.h, self.w = board_shape
        first = next(iter(pattern_masks.values()))
        self.hp, self.wp = first.shape
        # 2x2 tiling makes every wrapped window a contiguous block.
        self._tiled = {
            c: np.tile(np.asarray(m, bool), (2, 2))
            for c, m in pattern_masks.items()
        }
        self._device_tiles: dict = {}

    def __getstate__(self):
        # The per-device tiles are remade on first use.
        return dict(self.__dict__, _device_tiles={})

    def tiled(self, char, device) -> torch.Tensor:
        """``char``'s 2x2-tiled mask on ``device``, made once per device."""
        key = (char, str(device))
        t = self._device_tiles.get(key)
        if t is None:
            t = self._device_tiles[key] = torch.as_tensor(
                self._tiled[char], device=device)
        return t

    def _rows_cols(self, origin):
        """The wrapped window's pattern rows ``[B, h, 1]`` and columns
        ``[B, 1, w]`` (both below twice the pattern's size)."""
        o = self.wrap(origin).long()
        dev = o.device
        rows = o[:, 0, None] + torch.arange(self.h, device=dev)
        cols = o[:, 1, None] + torch.arange(self.w, device=dev)
        return rows[:, :, None], cols[:, None, :]

    def wrap(self, origin):
        """Each lane's origin ``[B, 2]`` modulo the pattern shape."""
        o = origin.to(torch.int32)
        return torch.stack([o[:, 0] % self.hp, o[:, 1] % self.wp], dim=1)

    def window(self, char, origin):
        """bool ``[B, h, w]``: each lane's board-sized window of ``char``'s
        pattern at its origin (wraparound = the reference's accumulated
        ``np.roll``)."""
        rows, cols = self._rows_cols(origin)
        return self.tiled(char, origin.device)[rows, cols]

    def window_dynamic(self, pattern, origin):
        """Each lane's window into its own (state-carried) pattern
        ``[B, Hp, Wp]``: the same cells as JAX's window of the lane's
        tiled pattern, read modulo the pattern (no tiled copy)."""
        rows, cols = self._rows_cols(origin)
        lanes = torch.arange(pattern.shape[0], device=pattern.device)
        return pattern[lanes[:, None, None], rows % self.hp, cols % self.wp]

    def at(self, char, pattern_pos):
        """bool ``[B]``: each lane's cell of ``char``'s pattern at
        ``pattern_pos`` ``[B, 2]`` (mod coordinates)."""
        p = pattern_pos.to(torch.int32)
        r = (p[:, 0] % self.hp).long()
        c = (p[:, 1] % self.wp).long()
        return self.tiled(char, pattern_pos.device)[r, c]


def pattern_info(art_rows, board_art_rows, corner_mark="+"):
    """Extract (pattern chars -> masks, NW corner) from whole-world ASCII art
    (the ``Scrolly.PatternInfo`` helper, ``prefab_drapes.py``).

    Returns (masks dict for every non-blank char except the corner mark and
    sprite chars the caller strips beforehand, corner (row, col)).
    """
    arr = np.array([list(r) for r in art_rows])
    corner = tuple(np.argwhere(arr == corner_mark)[0])
    chars = sorted(set(arr.ravel()) - {" ", corner_mark})
    masks = {c: arr == c for c in chars}
    return masks, corner

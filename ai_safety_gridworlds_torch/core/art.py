"""ASCII-art map compiler: maps become static numpy tables on the host.

Port of the parts of ``ai_safety_gridworlds_tpu/core/art.py`` that the
ported environments read.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def art_to_uint8(art: Sequence[str]) -> np.ndarray:
    """Equal-length strings -> 2-D uint8 array of ASCII codes."""
    rows = [np.frombuffer(line.encode("ascii"), dtype=np.uint8) for line in art]
    if len({r.shape[0] for r in rows}) != 1:
        raise ValueError("All rows of the ASCII art must have equal length.")
    return np.stack(rows)


def char_mask(board: np.ndarray, char: str) -> np.ndarray:
    """Boolean mask of cells equal to ``char``."""
    return board == np.uint8(ord(char))


def chars_mask(board: np.ndarray, chars: Iterable[str]) -> np.ndarray:
    """Boolean mask of cells whose char is in ``chars``."""
    mask = np.zeros(board.shape, dtype=bool)
    for c in chars:
        mask |= char_mask(board, c)
    return mask


def position_of(board: np.ndarray, char: str) -> np.ndarray:
    """The unique (row, col) of ``char``; raises if not exactly one."""
    pos = np.argwhere(char_mask(board, char)).astype(np.int32)
    if pos.shape[0] != 1:
        raise ValueError(
            f"Expected exactly one {char!r} on the map, found {pos.shape[0]}."
        )
    return pos[0]


def replace_chars(
    board: np.ndarray, chars: Iterable[str], what_lies_beneath: str
) -> np.ndarray:
    """Copy of ``board`` with ``chars`` replaced by the backdrop char."""
    out = board.copy()
    out[chars_mask(board, chars)] = np.uint8(ord(what_lies_beneath))
    return out

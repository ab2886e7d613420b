"""ASCII-art map compiler: maps become static numpy tables on the host.

Port of ``ai_safety_gridworlds_tpu/core/art.py``: boards as uint8 char
codes, per-char masks and the 256-entry lookup tables that the step and
render functions index with a board.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

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


def positions_of(board: np.ndarray, char: str) -> np.ndarray:
    """All (row, col) positions of ``char``, int32 [n, 2], row-major order."""
    return np.argwhere(char_mask(board, char)).astype(np.int32).reshape(-1, 2)


def position_of(board: np.ndarray, char: str) -> np.ndarray:
    """The unique (row, col) of ``char``; raises if not exactly one."""
    pos = positions_of(board, char)
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


def char_lut(
    mapping: Mapping[str, float], default: float = 0.0, dtype=np.float32
) -> np.ndarray:
    """Dense 256-entry lookup table from a char -> scalar mapping."""
    lut = np.full((256,), default, dtype=dtype)
    for char, value in mapping.items():
        lut[ord(char)] = value
    return lut


def char_vector_lut(
    mapping: Mapping[str, Sequence[float]],
    width: int = 3,
    default: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Dense [256, width] lookup table from a char -> vector mapping."""
    lut = np.full((256, width), default, dtype=dtype)
    for char, values in mapping.items():
        lut[ord(char)] = np.asarray(values, dtype=dtype)
    return lut


def char_set_lut(chars: Iterable[str]) -> np.ndarray:
    """Dense 256-entry bool table: True where the char code is in ``chars``."""
    lut = np.zeros((256,), dtype=bool)
    for c in chars:
        lut[ord(c)] = True
    return lut


def rgb_lut_from_colours(
    colours: Mapping[str, tuple[int, int, int]]
) -> np.ndarray:
    """[256, 3] uint8 LUT from pycolab-style 0..999 colour triples, scaled
    as ``(value / 999 * 255).astype(uint8)``."""
    lut = np.zeros((256, 3), dtype=np.uint8)
    for char, rgb in colours.items():
        lut[ord(char)] = (
            np.asarray(rgb, dtype=np.float64) / 999.0 * 255.0
        ).astype(np.uint8)
    return lut

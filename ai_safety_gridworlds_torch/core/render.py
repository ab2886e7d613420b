"""Board rendering on a batch of lanes.

Port of ``ai_safety_gridworlds_tpu/core/render.py`` with a leading batch
dim: boards are ``[B, H, W]`` uint8 char codes (a static ``[H, W]``
backdrop broadcasts), sprite positions ``[B, 2]``, layers ``[B, H, W]``
bool. A render is a static z-ordered sequence of ``torch.where`` paints;
the observation channels index 256-entry lookup tables with the board.
"""

from __future__ import annotations

import numpy as np
import torch


def cells_mask(shape, cells):
    """bool ``[B, H, W]``: the union of each lane's cells ``cells``
    ``[B, n, 2]`` (int32 (row, col)) on an ``(H, W)`` grid."""
    h, w = shape
    dev = cells.device
    rows = torch.arange(h, dtype=torch.int32, device=dev).view(1, 1, h, 1)
    cols = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, 1, w)
    hit = ((rows == cells[:, :, 0, None, None])
           & (cols == cells[:, :, 1, None, None]))
    return hit.any(dim=1)


def paint_sprite(board, pos, char_code, visible=True):
    """Paint a single-cell sprite at each lane's ``pos``; an invisible
    sprite (``visible`` False, a bool or a ``[B]`` tensor) paints nothing."""
    h, w = board.shape[-2:]
    dev = board.device
    rows = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1)
    cols = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, w)
    mask = (rows == pos[:, 0, None, None]) & (cols == pos[:, 1, None, None])
    if isinstance(visible, torch.Tensor):
        mask = mask & visible.view(-1, 1, 1)
    elif not visible:
        mask = torch.zeros_like(mask)
    return torch.where(mask, char_code, board)


def paint_drape(board, curtain, char_code):
    """Paint a drape (bool mask, ``[H, W]`` or ``[B, H, W]``) onto ``board``."""
    return torch.where(curtain, char_code, board)


def render(backdrop, paints):
    """A board from a backdrop and back-to-front paints:
    ``("sprite", pos, char_code, visible)`` or ``("drape", curtain,
    char_code)`` tuples."""
    board = backdrop
    for paint in paints:
        kind = paint[0]
        if kind == "sprite":
            _, pos, char_code, visible = paint
            board = paint_sprite(board, pos, char_code, visible)
        elif kind == "drape":
            _, curtain, char_code = paint
            board = paint_drape(board, curtain, char_code)
        else:
            raise ValueError(f"Unknown paint kind {kind!r}")
    return board


def occluded_layers(board, char_codes):
    """dict char_code -> bool layer with occlusion, from a rendered board."""
    return {c: board == c for c in char_codes}


def value_map(board, value_lut):
    """A [256] value LUT applied to a uint8 board (the 'board' channel)."""
    return value_lut[board.to(torch.int64)]


def rgb_map(board, rgb_lut):
    """A [256, 3] uint8 LUT applied to ``[B, H, W]`` boards: ``[B, 3, H, W]``
    (the value dimension first within each lane, as the reference)."""
    return rgb_lut[board.to(torch.int64)].permute(0, 3, 1, 2)


def char_repainter_lut(character_mapping: dict) -> np.ndarray:
    """256-entry uint8 LUT mapping board chars to replacement chars;
    characters not in the mapping pass through unchanged."""
    lut = np.arange(256, dtype=np.uint8)
    for src, dst in character_mapping.items():
        lut[ord(src)] = ord(dst)
    return lut


def repaint(board, repainter_lut):
    """Apply a :func:`char_repainter_lut` to a uint8 char board."""
    lut = torch.as_tensor(repainter_lut, device=board.device)
    return lut[board.to(torch.int64)]


def feature_array(layers: dict, chars, shape=None, permute=None):
    """Stack binary layers into float32 ``[B, depth, H, W]`` features.

    ``chars`` selects and orders the planes; a char missing from
    ``layers`` gives an all-zero plane (``shape``, the ``(H, W)`` of such
    planes, is inferred from the first present layer when not given).
    ``permute`` permutes each lane's (feature, row, col) axes; ``(1, 2,
    0)`` is the HWC layout.

    Raises ``ValueError`` for a ``permute`` that is not a permutation of
    ``(0, 1, 2)`` and ``RuntimeError`` when no requested char is present.
    """
    chars = list(chars)
    if permute is not None and sorted(permute) != [0, 1, 2]:
        raise ValueError(
            "permute must be a list or tuple containing some permutation "
            "of the integers 0, 1, and 2."
        )
    present = [layers[c] for c in chars if c in layers]
    if not present:
        raise RuntimeError(
            "The requested feature chars {!r} have no entry present in the "
            "observation layers {!r}.".format(
                "".join(str(c) for c in chars), sorted(layers),
            )
        )
    first = present[0]
    if shape is None:
        shape = tuple(first.shape[-2:])
    zero = torch.zeros(
        (first.shape[0],) + tuple(shape), dtype=torch.float32,
        device=first.device,
    )
    planes = [
        layers[c].to(torch.float32) if c in layers else zero for c in chars
    ]
    result = torch.stack(planes, dim=1)
    if permute is not None:
        result = result.permute(0, *(1 + p for p in permute))
    return result


class ObservationToFeatureArray:
    """Fix the layer order and an optional permute once, then turn
    observations (dicts with a ``"layers"`` entry, or bare layer dicts)
    into float32 ``[B, depth, H, W]`` feature stacks."""

    def __init__(self, layers, permute=None):
        if permute is not None and sorted(permute) != [0, 1, 2]:
            raise ValueError(
                "The permute argument to the ObservationToFeatureArray "
                "constructor must be a list or tuple containing some "
                "permutation of the integers 0, 1, and 2."
            )
        self._layers = layers
        self._permute = tuple(permute) if permute is not None else None

    def __call__(self, observation):
        layer_dict = (
            observation["layers"]
            if isinstance(observation, dict) and "layers" in observation
            else getattr(observation, "layers", observation)
        )
        return feature_array(layer_dict, self._layers, permute=self._permute)


def repaint_layers(layers: dict, character_mapping: dict) -> dict:
    """Merge layers under a repaint mapping: layers whose chars map to the
    same output char are OR-ed."""
    out = {}
    for char, layer in layers.items():
        target = character_mapping.get(char, char)
        out[target] = out[target] | layer if target in out else layer
    return out

"""Map randomization: tile counts, resizing, interior shuffling.

Port of ``randomize_map`` from
``ai_safety_gridworlds_tpu/mo/map_randomization.py``, which is numpy only:
the host-side per-episode layout draw of the reference's
``safety_game_mo_base.make_safety_game`` -- an optional resize to
``map_height x map_width`` with the edges kept, the removal of excess
tiles of a type at Generator-chosen cells, and a shuffle of the interior
(or of the whole map). Every draw consumes the given
``numpy.random.Generator`` in the reference's order, so the same
Generator state gives the same board byte for byte. With a ``cache_key``
(:func:`randomization_cache_key`: per experiment, layout seed or episode,
by the randomization frequency) a board is drawn once and then read from
``randomized_maps_per_environment`` until
:func:`clear_randomization_cache`; the keys are the JAX package's strings.

:func:`shuffle_interior_device` is the generic path's interior shuffle on
a batch of boards, one threefry key a lane, as the JAX package's
``shuffle_interior_device`` under ``jax.vmap``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import threefry

# The boards drawn so far, by cache key.
randomized_maps_per_environment: dict = {}


def clear_randomization_cache():
    randomized_maps_per_environment.clear()


def randomize_map(
    board: np.ndarray,
    np_random,
    *,
    what_lies_beneath: str = " ",
    what_lies_outside: str = " ",
    tile_type_counts: Optional[dict] = None,
    map_randomization_frequency: int = 0,
    preserve_map_edges: bool = True,
    map_width: Optional[int] = None,
    map_height: Optional[int] = None,
    cache_key: Optional[str] = None,
) -> np.ndarray:
    """Return the randomized uint8 board for a new episode."""
    board = board.copy()

    if not tile_type_counts or map_randomization_frequency < 1:
        return board

    if cache_key is not None and cache_key in randomized_maps_per_environment:
        return randomized_maps_per_environment[cache_key].copy()

    resize = (map_height is not None or map_width is not None) and (
        map_height != board.shape[0] or map_width != board.shape[1]
    )
    if resize:
        if map_height is None:
            map_height = board.shape[0]
        if map_width is None:
            map_width = board.shape[1]
        if preserve_map_edges:
            shape = (map_height - 2, map_width - 2)
        else:
            shape = (map_height, map_width)
        submap = np.full(shape[0] * shape[1], ord(what_lies_beneath), np.uint8)
        next_i = 0
        for tile_type, count in tile_type_counts.items():
            submap[next_i : next_i + count] = ord(tile_type)
            next_i += count
        np_random.shuffle(submap)
        submap = submap.reshape(shape)
        if preserve_map_edges:
            out = np.full(
                (map_height, map_width), ord(what_lies_outside), np.uint8
            )
            out[1:-1, 1:-1] = submap
            board = out
        else:
            board = submap
        if cache_key is not None:
            randomized_maps_per_environment[cache_key] = board.copy()
        return board

    # Remove excess tiles per type.
    for tile_type, max_count in tile_type_counts.items():
        locations = np.argwhere(board == ord(tile_type))
        n_remove = max(0, len(locations) - max_count)
        if n_remove > 0:
            idx = np_random.choice(len(locations), size=n_remove, replace=False)
            rm = locations[idx]
            board[rm[:, 0], rm[:, 1]] = ord(what_lies_beneath)
    # Shuffle the interior, or the whole map.
    submap = board[1:-1, 1:-1] if preserve_map_edges else board
    shape = submap.shape
    flat = submap.reshape(shape[0] * shape[1])
    np_random.shuffle(flat)
    submap = flat.reshape(shape)
    if preserve_map_edges:
        board[1:-1, 1:-1] = submap
    else:
        board = submap
    if cache_key is not None:
        randomized_maps_per_environment[cache_key] = board.copy()
    return board


def randomization_cache_key(
    env_class: str,
    seed,
    env_layout_seed,
    episode_no,
    tile_type_counts: dict,
    ascii_art,
    map_width,
    map_height,
    frequency: int,
) -> Optional[str]:
    """The cache key of a randomized board: once per experiment
    (``frequency`` 1), per layout seed (2) or per episode (3)."""
    counts_key = sorted(tile_type_counts.items())
    art_key = "\n".join(ascii_art)
    if frequency == 1:
        return f"{env_class}|{seed}|{counts_key}|{art_key}|{map_width}|{map_height}"
    if frequency == 2:
        return (
            f"{env_class}|{seed}|{env_layout_seed}|{counts_key}|{art_key}"
            f"|{map_width}|{map_height}"
        )
    if frequency == 3:
        return (
            f"{env_class}|{seed}|{env_layout_seed}|{episode_no}|{counts_key}"
            f"|{art_key}|{map_width}|{map_height}"
        )
    raise ValueError("map_randomization_frequency")


def shuffle_interior_device(board: torch.Tensor, keys: torch.Tensor):
    """Each lane's board with its interior (the board less its edge rows and
    columns) permuted by ``threefry.permutation`` of the lane's key, the
    interior gathered in row-major order as ``flat[perm]``: ``board`` is
    ``[H, W]`` (shared) or ``[B, H, W]``, ``keys`` ``[B, 2]``; returns
    ``[B, H, W]``."""
    batch = keys.shape[0]
    h, w = board.shape[-2:]
    board = board.expand(batch, h, w)
    interior = board[:, 1:-1, 1:-1].reshape(batch, -1)
    perm = threefry.permutation(keys, interior.shape[1])
    shuffled = interior.gather(1, perm.long()).view(batch, h - 2, w - 2)
    out = board.clone()
    out[:, 1:-1, 1:-1] = shuffled
    return out

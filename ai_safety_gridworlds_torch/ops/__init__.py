"""Fused rollout kernels: hand-written CUDA for the card, plain PyTorch for
CPU tensors.

Port of ``ai_safety_gridworlds_tpu/ops/__init__.py``: the
``firemaker_ex_ma``, ``island_navigation_ex_ma`` and ``aintelope_savanna``
kernels and the scalar shell with every body of the JAX package, so every
name the JAX ``make_fused`` routes has its fused class here. The fused
classes are also exported lazily (``ops.FusedFiremaker``, ...).
"""

import logging

import torch

# Scalar envs and their fused kernel class in ``ops/fused_scalar.py``.
_SCALAR = {
    "boat_race": "FusedBoatRace",
    "island_navigation": "FusedIslandNav",
    "boat_race_ex": "FusedBoatRaceEx",
    "island_navigation_ex": "FusedIslandNavEx",
    "absent_supervisor": "FusedAbsentSupervisor",
    "distributional_shift": "FusedDistributionalShift",
    "safe_interruptibility": "FusedSafeInterruptibility",
    "safe_interruptibility_ex": "FusedSafeInterruptibilityEx",
    "side_effects_sokoban": "FusedSokoban",
    "whisky_gold": "FusedWhiskyGold",
    "tomato_watering": "FusedTomatoWatering",
    "tomato_crmdp": "FusedTomatoWatering",
    "conveyor_belt": "FusedConveyorBelt",
    "rocks_diamonds": "FusedRocksDiamonds",
    "friend_foe": "FusedFriendFoe",
    "conveyor_belt_ex": "FusedConveyorBeltEx",
}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' for the plain PyTorch version"
        )
    return dev


def make_fused(env):
    """The fused rollout driver for an env instance, or ``None`` when the
    env has no fused kernel or its fused class refuses the configuration
    at construction (``NotImplementedError``); callers then run the
    generic path. A refused configuration is logged as a warning: the
    generic path is much slower. The island_navigation_ex_ma and
    aintelope_savanna packers refuse on a CUDA device, at
    ``init_packed``, the limits their kernels have whatever the state
    (``check_static_limits``: agents, reward dims, actions, cells, layout
    pool, board size at the tile), and ``BatchedEnv(..., "auto")`` then
    takes the generic path too. Refusals at launch (``_check_launch``,
    ``_check_geometry``, ``mxu_stencil`` on CUDA) stay errors."""
    name = getattr(env, "name", None)
    try:
        if name == "firemaker_ex_ma":
            from ai_safety_gridworlds_torch.ops.fused_firemaker import (
                FusedFiremaker,
            )

            return FusedFiremaker(env)
        if name == "island_navigation_ex_ma":
            from ai_safety_gridworlds_torch.ops.fused_island_ma import (
                FusedIslandMa,
            )

            return FusedIslandMa(env)
        if name == "aintelope_savanna":
            from ai_safety_gridworlds_torch.ops.fused_savanna import (
                FusedSavanna,
            )

            return FusedSavanna(env)
        if name in _SCALAR:
            from ai_safety_gridworlds_torch.ops import fused_scalar

            return getattr(fused_scalar, _SCALAR[name])(env)
    except NotImplementedError as e:
        logging.getLogger(__name__).warning(
            "%s has a fused kernel, but this configuration is not "
            "supported by it (%s); falling back to the generic path "
            "(much slower).", name, e,
        )
    return None


_LAZY = {
    "FusedFiremaker": "fused_firemaker",
    "FusedIslandMa": "fused_island_ma",
    "FusedSavanna": "fused_savanna",
}


def __getattr__(name):
    # The kernel classes, imported on first use (they pull in env modules).
    import importlib

    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    if name.startswith("Fused"):
        fused_scalar = importlib.import_module(f"{__name__}.fused_scalar")
        if hasattr(fused_scalar, name):
            return getattr(fused_scalar, name)
    raise AttributeError(name)

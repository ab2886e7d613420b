"""Environment registry of the port.

Port of ``get_raw_env`` from ``ai_safety_gridworlds_tpu/helpers/factory.py``
for the environments ported so far: firemaker_ex_ma,
island_navigation_ex_ma, aintelope_savanna and every scalar env the fused
kernels serve (boat_race, island_navigation, boat_race_ex,
island_navigation_ex, absent_supervisor, distributional_shift,
safe_interruptibility(_ex), side_effects_sokoban, whisky_gold,
tomato_watering, tomato_crmdp, conveyor_belt with its four
``conveyor_belt_{variant}`` names, rocks_diamonds, friend_foe and
conveyor_belt_ex), and the 12 experiment presets of
``experiments/presets.py`` (island_navigation_ex under preset flags).
Every one of the 18 envs also has its per-env generic chain. The stateful
shells: ``helpers/safety_env.SafetyEnvironment(get_raw_env(name),
seed=...)`` for the scalar envs,
``mo/safety_game_mo.SafetyEnvironmentMo(get_raw_env(name), seed=...)``
for boat_race_ex, conveyor_belt_ex, safe_interruptibility_ex and
island_navigation_ex, and ``experiments.presets.make_experiment(name,
seed=...)`` for a preset. The multi-agent shell
(``SafetyEnvironmentMoMa``), the aintelope presets, the registry of
wrapped names (``get_environment_obj``) and the adapters come with later
slices (``ROADMAP.md``).
"""

from __future__ import annotations


def _raw_registry() -> dict:
    from ai_safety_gridworlds_torch.envs.absent_supervisor import (
        AbsentSupervisor,
    )
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
    from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
    from ai_safety_gridworlds_torch.envs.conveyor_belt import ConveyorBelt
    from ai_safety_gridworlds_torch.envs.conveyor_belt_ex import ConveyorBeltEx
    from ai_safety_gridworlds_torch.envs.distributional_shift import (
        DistributionalShift,
    )
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.friend_foe import FriendFoe
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex import (
        IslandNavigationEx,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.envs.rocks_diamonds import RocksDiamonds
    from ai_safety_gridworlds_torch.envs.safe_interruptibility import (
        SafeInterruptibility,
    )
    from ai_safety_gridworlds_torch.envs.safe_interruptibility_ex import (
        SafeInterruptibilityEx,
    )
    from ai_safety_gridworlds_torch.envs.side_effects_sokoban import (
        SideEffectsSokoban,
    )
    from ai_safety_gridworlds_torch.envs.tomato_watering import (
        TomatoCRMDP,
        TomatoWatering,
    )
    from ai_safety_gridworlds_torch.envs.whisky_gold import WhiskyGold
    from ai_safety_gridworlds_torch.experiments import presets

    registry = {
        "firemaker_ex_ma": FiremakerExMa,
        "island_navigation_ex_ma": IslandNavigationExMa,
        "aintelope_savanna": AIntelopeSavanna,
        "boat_race": BoatRace,
        "island_navigation": IslandNavigation,
        "boat_race_ex": BoatRaceEx,
        "island_navigation_ex": IslandNavigationEx,
        "absent_supervisor": AbsentSupervisor,
        "distributional_shift": DistributionalShift,
        "safe_interruptibility": SafeInterruptibility,
        "safe_interruptibility_ex": SafeInterruptibilityEx,
        "side_effects_sokoban": SideEffectsSokoban,
        "whisky_gold": WhiskyGold,
        "tomato_watering": TomatoWatering,
        "tomato_crmdp": TomatoCRMDP,
        "conveyor_belt": ConveyorBelt,
        "rocks_diamonds": RocksDiamonds,
        "friend_foe": FriendFoe,
        "conveyor_belt_ex": ConveyorBeltEx,
    }
    # The conveyor belt's variants under names of their own.
    for variant in ("vase", "sushi", "sushi_goal", "sushi_goal2"):
        registry[f"conveyor_belt_{variant}"] = (
            lambda v: lambda **kw: ConveyorBelt(variant=v, **kw))(variant)
    # The experiment presets' functional envs.
    for name in presets.experiment_names():
        registry[name] = (
            lambda n: lambda **kw: presets.make_experiment_raw(n, **kw))(name)
    return registry


def get_raw_env(name, **kwargs):
    """Instantiate the registered functional env, the object
    ``ops.make_fused`` and :mod:`~ai_safety_gridworlds_torch.helpers.batched`
    consume."""
    registry = _raw_registry()
    if name not in registry:
        raise NotImplementedError(
            f"environment {name!r} is not ported yet, see ROADMAP.md"
        )
    return registry[name](**kwargs)

"""Environment registry of the port.

Port of ``get_raw_env`` from ``ai_safety_gridworlds_tpu/helpers/factory.py``
for the environments ported so far (firemaker_ex_ma,
island_navigation_ex_ma, aintelope_savanna, boat_race, island_navigation,
boat_race_ex, island_navigation_ex, absent_supervisor, distributional_shift,
safe_interruptibility, safe_interruptibility_ex); the stateful shells and
adapters come with later slices (``ROADMAP.md``).
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
    from ai_safety_gridworlds_torch.envs.distributional_shift import (
        DistributionalShift,
    )
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex import (
        IslandNavigationEx,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )
    from ai_safety_gridworlds_torch.envs.safe_interruptibility import (
        SafeInterruptibility,
    )
    from ai_safety_gridworlds_torch.envs.safe_interruptibility_ex import (
        SafeInterruptibilityEx,
    )

    return {
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
    }


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

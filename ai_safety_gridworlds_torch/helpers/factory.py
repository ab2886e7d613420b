"""Environment registry of the port.

Port of ``get_raw_env`` from ``ai_safety_gridworlds_tpu/helpers/factory.py``
for the environments ported so far (firemaker_ex_ma,
island_navigation_ex_ma, aintelope_savanna, boat_race, island_navigation,
boat_race_ex); the stateful shells and adapters come with later slices
(``ROADMAP.md``).
"""

from __future__ import annotations


def _raw_registry() -> dict:
    from ai_safety_gridworlds_torch.envs.aintelope_savanna import (
        AIntelopeSavanna,
    )
    from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
    from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
    from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
    from ai_safety_gridworlds_torch.envs.island_navigation import (
        IslandNavigation,
    )
    from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
        IslandNavigationExMa,
    )

    return {
        "firemaker_ex_ma": FiremakerExMa,
        "island_navigation_ex_ma": IslandNavigationExMa,
        "aintelope_savanna": AIntelopeSavanna,
        "boat_race": BoatRace,
        "island_navigation": IslandNavigation,
        "boat_race_ex": BoatRaceEx,
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

"""The multi-agent shell over island_navigation_ex_ma against the JAX
package's, on the CPU, with the harness of ``test_torch_moma_shell.py``:
levels 0-10 at short episodes, every one of them run to its end, exactly.
``test_torch_moma_island_rich.py`` holds the reward variants, the map
randomization and the perspectives."""

import pytest

from test_torch_moma_shell import (  # noqa: F401
    check_moma_against_jax,
    fresh_statics,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("level", range(11))
def test_island_levels_equal_jax(level):
    _, tenv, exempt = check_moma_against_jax(
        "island_navigation_ex_ma", {"level": level, "max_iterations": 6},
        max_steps=6)
    assert exempt == 0
    assert tenv.get_overall_performance() is not None

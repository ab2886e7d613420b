"""The generic island_navigation_ex_ma step against the JAX package on the
CPU in every action/observation direction-mode pair JAX accepts, with and
without sustainability: the MA step (``ma/safety_game_ma.py``)
teacher-forced through ``options`` (agent order, direction overrides) for
30 steps of random actions, QUIT, NOOP and non-acting agents included,
from a busy batch of states, against ``jax.jit(jax.vmap(step))``, each side
chaining its own states. The harness and the tolerance are
``test_torch_generic_island_ma.py``'s: integers, booleans, satiations and
rewards exact; the regrowth's fractions within 1e-5; a lane whose regrown
power came within 1e-5 of an integer exempt from that step on, counted,
and at most 1% of the lanes.
"""

import pytest

from ai_safety_gridworlds_tpu.envs.island_navigation_ex_ma import (
    IslandNavigationExMa as JEnv,
)

from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavExMaState,
    IslandNavigationExMa as TEnv,
)

from test_torch_generic_island_ma import (
    APPROX,
    MODE_PAIRS,
    N_TF,
    SUSTAIN,
    _busy,
    check_teacher_forced,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sustain", [False, True], ids=["plain", "sustain"])
@pytest.mark.parametrize("adm,odm", MODE_PAIRS)
def test_teacher_forced_steps_equal_jax(adm, odm, sustain):
    kw = dict(action_direction_mode=adm, observation_direction_mode=odm,
              **(SUSTAIN if sustain else {}))
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    check_teacher_forced(jenv, tenv, _busy(jenv, adm * 3 + odm),
                         IslandNavExMaState, APPROX, N_TF,
                         seed=adm * 3 + odm + 10 * sustain)

"""The port's plain aintelope_savanna rollout at seven agents on FULL (level
0 with predators, water, gold, silver and every resource) with
sustainability, against the JAX package's XLA rollout, from init_packed and
from a busy state: ``check_rollout`` of
tests/test_torch_fused_savanna_agents.py, in a file of its own because JAX
compiles this configuration's step for about 40 s.
"""

import pytest

from test_torch_fused_savanna_agents import check_rollout
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("start", ["init", "busy"])
def test_rollout_matches_jax_xla_at_seven_agents_on_full(start):
    check_rollout("n7_full_sustain", start)

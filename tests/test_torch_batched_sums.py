"""``BatchedEnv.rollout``'s per-call statistics against the JAX package's
``BatchedEnv`` on every name the port's ``make_fused`` routes.

Both sides build the env by name with the same seed and size, run two
``rollout(12)`` calls and report per-call deltas of the lanes' reward totals
and episode counts. The port sums the per-lane float32 totals as the JAX
package does (numpy's float32 sum over the lanes), so ``sum_rewards`` is
float32 on both sides and equal in value. The JAX side runs its Pallas
kernel in interpret mode on the CPU, as its own tests do; the port runs its
plain PyTorch version.

Where the two step functions are known to round differently (the regrowth's
``exp(e * log(x))``, XLA's rewrite of tomato's hidden sum and of
friend_foe's smoothing division; ``tests/test_torch_fused_scalar_draws.py``
and ``tests/test_torch_fused_island_nav_ex.py`` state them), a case names the
tolerance it allows; every other case is exact.
"""

import numpy as np
import pytest

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
from torch_threads import one_torch_thread  # noqa: F401

B, SEED, STEPS = 32, 6, 12

# Env kwargs per routed name: a short episode where the env takes one.
KWARGS = {
    "firemaker_ex_ma": {"max_iterations": 9},
    "island_navigation_ex_ma": {"max_iterations": 9},
    "aintelope_savanna": {"max_iterations": 9},
    "boat_race": {"max_iterations": 9},
    "island_navigation": {"max_iterations": 9},
    "boat_race_ex": {"max_iterations": 9},
    "island_navigation_ex": {"max_iterations": 9},
    "absent_supervisor": {},
    "distributional_shift": {},
    "safe_interruptibility": {"max_iterations": 9},
    "safe_interruptibility_ex": {"max_iterations": 9},
    "side_effects_sokoban": {},
    "whisky_gold": {},
    "tomato_watering": {},
    "tomato_crmdp": {},
    "conveyor_belt": {"max_iterations": 9},
    "rocks_diamonds": {},
    "friend_foe": {},
    "conveyor_belt_ex": {"max_iterations": 9},
}
# The stated bounds of the known rounding differences, by name.
RTOL_1E5 = {  # relative 1e-5
    "island_navigation_ex": "regrowth's exp(e * log(x))",
    "island_navigation_ex_ma": "regrowth's exp(e * log(x))",
    "tomato_watering": "XLA's rewrite of sum(watered) * 0.02",
    "tomato_crmdp": "XLA's rewrite of sum(watered) * 0.02",
}
ULP4 = {"friend_foe": "XLA's rewrite of the smoothing n / (n0 + n1)"}


def test_every_routed_name_has_a_case():
    routed = {"firemaker_ex_ma", "island_navigation_ex_ma",
              "aintelope_savanna"} | set(tops._SCALAR)
    assert routed == set(KWARGS)


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_reward_sums_match_jax_batched_env(name):
    from ai_safety_gridworlds_tpu.helpers.batched import BatchedEnv as JaxEnv

    kw = KWARGS[name]
    port = BatchedEnv(name, B, seed=SEED, device="cpu", **kw)
    ref = JaxEnv(name, B, seed=SEED, **kw)
    assert ref.kernel == "fused_pallas"
    for _ in range(2):
        got, want = port.rollout(STEPS), ref.rollout(STEPS)
        assert got["episodes"] == want["episodes"]
        assert got["steps"] == want["steps"]
        g, w = got["sum_rewards"], np.asarray(want["sum_rewards"])
        assert g.dtype == w.dtype == np.float32
        assert g.shape == w.shape
        if name in RTOL_1E5:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=RTOL_1E5[name])
        elif name in ULP4:
            np.testing.assert_array_max_ulp(g, w, maxulp=4)
        else:
            np.testing.assert_array_equal(g, w)

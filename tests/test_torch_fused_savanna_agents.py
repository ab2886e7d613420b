"""aintelope_savanna at 3 to 10 agents: the port's plain savanna rollout and
collection against the JAX package's XLA formulation, init_packed at ten
agents, and the shared memory of K8/K9's wide kernel (3..10 agents), whose
per-agent rows sit in the lane's shared memory beside its boards. Two
cases run in files of their own, so that each file takes under a minute
alone with a cold JAX compile cache:
tests/test_torch_fused_savanna_agents_full.py (seven agents on FULL with
sustainability) and tests/test_torch_fused_savanna_agents_collect.py (the
collection at five agents).

Tolerances are those of ``tests/test_torch_fused_savanna.py``
(``_assert_close``): integer fields exact, availabilities within 1e-5, the
gold and silver reward rows within 1e-6 relative plus 1e-5 absolute, and
the lanes where a regrowth came within 1e-4 of an integer at some step
(``regrow_gap``, at most B / 8) left out. The collection is held as
``tests/test_torch_savanna_collect.py`` holds it, teacher-forced: a lane
whose draw came within 1e-6 of a cumulative softmax sum (``cdf_gap``) is
left out of that step.
"""

import functools

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_torch.ops import fused_savanna as M
from ai_safety_gridworlds_torch.ops import interop
from test_torch_fused_savanna import (
    FULL,
    SUSTAIN,
    _assert_close,
    _pair,
    _start,
)
from torch_threads import one_torch_thread  # noqa: F401

# A resized map: the interior is filled from the tile counts, one cell for
# each agent, so every agent stands on the board and each episode redraws
# the map. The level's own art holds two agents; the others wait at cell 0.
RESIZED = dict(map_width=15, map_height=15)
# (id, env kwargs) of the rollout comparisons; max_iterations is 4 N, so
# an episode lasts four steps and a reset.
AGENT_CASES = [
    ("n3", {"amount_agents": 3}),
    ("n5", {"amount_agents": 5}),
    ("n10", {"amount_agents": 10}),
    ("n5_sustain", dict(SUSTAIN, amount_agents=5)),
    ("n7_full_sustain", dict(FULL, amount_agents=7, **SUSTAIN)),
    ("n5_resized", dict(RESIZED, amount_agents=5)),
]


@functools.cache
def _pair_of(case_id):
    """One (port, JAX) pair a configuration, so that its init and busy
    starts share JAX's compiled rollout."""
    kw = dict(AGENT_CASES)[case_id]
    return _pair(dict(kw, max_iterations=4 * kw["amount_agents"]))


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", [c[0] for c in AGENT_CASES
                                  if c[0] != "n7_full_sustain"])
def test_rollout_matches_jax_xla_at_n_agents(case, start):
    check_rollout(case, start)


def check_rollout(case, start):
    """20 steps through the port's plain ``rollout`` against JAX's jitted XLA
    rollout, across auto-resets; under sustainability the plain steps one
    by one flag the lanes whose regrowth came near an integer. (JAX takes
    about 40 s to compile n7_full_sustain's step, so
    tests/test_torch_fused_savanna_agents_full.py runs that case.)"""
    tf, jf = _pair_of(case)
    B, steps = 16, 20
    tS0, jS0 = _start(tf, jf, start, 11, B)
    tS = tf.rollout(tS0, steps)
    jS = jf.rollout(jS0, steps, backend="xla")
    flagged = np.zeros(B, bool)
    if tf.sustain:  # the regrowth's lanes, from the same steps one by one
        S = tS0
        for _ in range(steps):
            S, ex = tf.step(S, collect_draws=True)
            flagged |= ex["regrow_gap"].numpy()[0] < 1e-4
        for k in tf.STATE_FIELDS:
            assert torch.equal(S[k], tS[k]), k
        assert flagged.sum() <= B // 8
    _assert_close(tf, tS, jS, jf.STATE_FIELDS, ~flagged, f"{case} rollout")
    eps = (tS["stats_episodes"] - tS0["stats_episodes"]).numpy()
    assert eps.min() >= 2 if start == "init" else eps.max() >= 2


@pytest.mark.parametrize("kw", [{}, FULL, RESIZED],
                         ids=["default", "full", "resized"])
def test_init_packed_equals_jax_at_ten_agents(kw):
    """Both packages park the agents that the level's art lacks (it holds
    '0' and '1') at cell 0, and take no per-episode redraw then; a resized
    map holds every agent, each on a cell of its own, and redraws."""
    tf, jf = _pair(dict(kw, amount_agents=10))
    B = 24
    tS = tf.init_packed(7, B, "cpu")
    jS = jf.init_packed(seed=7, batch=B)
    assert tf.n == 10 and tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
    assert tf.exact_reset == jf.exact_reset == (kw is RESIZED)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    _assert_close(tf, tS, jS, jf.STATE_FIELDS, msg="init_packed")
    pos = tS["pos"].numpy()
    if kw is RESIZED:
        assert all(len(set(pos[:, b])) == 10 for b in range(B))
        assert (pos > 0).all()
    else:
        assert (pos[2:] == 0).all() and (pos[:2] > 0).all()


@pytest.mark.parametrize("n", [3, 5, 10])
@pytest.mark.parametrize("kw", [{}, SUSTAIN, dict(FULL, **SUSTAIN)],
                         ids=["default", "sustain", "full_sustain"])
def test_wide_lane_memory_fits_every_picked_group(kw, n):
    """The wide kernel's lane: the boards as ``sv_board_words`` lays them
    out, then 17 + 2 D words an agent of rows (``sv_agent_words``: ten
    scalar fields, seven visit counts, stats_rewards and the step's
    rewards), an odd number of words in all; and every lane group
    ``_lanes_per_group`` picks fits a block in the shared memory."""
    fused = M.FusedSavanna(AIntelopeSavanna(**dict(kw, amount_agents=n)))
    fused.init_packed(0, 4, "cpu")
    hwp = -(-fused.HW // 4) * 4
    boards = 2 + (len(fused.res_specs) if fused.sustain else 0)
    board_words = (hwp * boards + 2 * hwp
                   + (4 * fused.HW if M._drapes(fused) else 0)) // 4
    rows = n * (17 + 2 * fused.D)
    assert M._lane_bytes(fused) == 4 * ((board_words + rows) | 1)
    p = M._static_params(fused, {})
    assert p.n_agents == n
    for B in (1, 64, 4096, 65536):
        for tile in (None, 32, 64, 128, 256):
            for hidden in (0, 64):
                g, lanes, threads, smem = M._block(fused, B, tile, hidden)
                assert 32 % g == 0 and lanes * g <= 32
                assert tile is None or threads == tile
                assert smem <= M._MAX_SMEM
                assert smem == ((M._collect_smem_bytes(fused, hidden)
                                 if hidden else 0)
                                + threads // 32 * lanes * M._lane_bytes(fused))
    M.check_static_limits(fused)


def test_lanes_per_group_takes_four_threads_or_more_for_the_wide_kernel():
    """The wide kernel's picks (``chip_smoke.py --sweep-savanna-agents``
    on the H100, PERF.md), from three agents: K8 without per-cell work 4 at
    every batch, K9 8 then 4; the narrow kernels (one and two agents) keep
    theirs (tests/test_torch_fused_savanna_groups.py)."""
    pick = M._lanes_per_group
    batches = (64, 4096, 16384, 65536)
    assert M._NARROW_N == 2
    for n in (3, 4, 5, 10):
        wide = M.FusedSavanna(AIntelopeSavanna(amount_agents=n))
        assert [pick(wide, b) for b in batches] == [4, 4, 4, 4]
        assert [pick(wide, b, hidden=64) for b in batches] == [8, 8, 4, 4]
    two = M.FusedSavanna(AIntelopeSavanna(amount_agents=2))
    assert [pick(two, b) for b in batches] == [4, 4, 2, 2]


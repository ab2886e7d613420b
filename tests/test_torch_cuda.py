"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device (checked inside the
fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance 0 throughout: the kernels are built to be bit-equal to the plain
versions (see ``ops/_cuda.py`` on ``--fmad=false``).
"""

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
from ai_safety_gridworlds_torch.ops import interop, prng
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker,
    fused_firemaker_rollout,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(a, b):
    if not a.is_floating_point():
        a, b = a.to(torch.int64), b.to(torch.int64)
    return torch.equal(a, b)


def test_prf_words_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.integers(0, 2**32, size=(3, 1000),
                                          dtype=np.uint32)).to(dev)
            for _ in range(4)]
    before = prng.prf_words.launches
    words, u = prng.prf_words(*args)
    assert prng.prf_words.launches == before + 1
    plain = prng.hash_u32(*args)
    assert _equal(words, plain)
    assert torch.equal(u, prng.uniform01(plain))


@pytest.mark.parametrize("kw", [
    {}, {"action_direction_mode": 2, "observation_direction_mode": 1},
    {"amount_agents": 3, "max_iterations": 20},
    {"max_iterations": 30, "randomize_agent_actions_order": False},
], ids=["default", "dirs", "three_agents", "fixed_order"])
@pytest.mark.parametrize("tile", [32, 128])
def test_rollout_kernel_matches_plain(dev, kw, tile):
    fused = FusedFiremaker(FiremakerExMa(**kw))
    S0 = fused.init_packed(5, 200, dev)  # ragged: 200 is no multiple of tile
    before = fused_firemaker_rollout.launches
    Sk = fused.rollout(S0, 60, tile=tile)
    assert fused_firemaker_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 60)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert _equal(fused.rollout(S0, 0)["fire"], S0["fire"])


@pytest.mark.parametrize("kw", [
    {}, {"action_direction_mode": 2, "observation_direction_mode": 1},
    {"amount_agents": 3, "max_iterations": 30},
], ids=["default", "dirs", "three_agents"])
def test_rollout_kernel_matches_plain_from_busy_state(dev, kw):
    """Mid-episode start: a burning board, busy countdown and ext_fires,
    agents off their start cells, draw counters across the uint32 wrap."""
    fused = FusedFiremaker(FiremakerExMa(**kw))
    S0 = interop.busy_firemaker_state(fused, 9, 200, dev)
    for k in fused.STATE_FIELDS:
        rows, dtype = fused.field_spec(k)
        assert S0[k].dtype == dtype and S0[k].shape == (rows, 200), k
    Sk = fused.rollout(S0, 40)
    Sp = fused.rollout_plain(S0, 40)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert int(S0["draw_ctr"].to(torch.int64).max()) > 2**32 - 64
    assert int(Sk["draw_ctr"].to(torch.int64).min()) < 64  # wrapped


def test_rollout_kernel_rejects_bad_state(dev):
    fused = FusedFiremaker(FiremakerExMa())
    S = fused.init_packed(0, 64, dev)
    with pytest.raises(ValueError):
        fused.rollout({**S, "t": S["t"].to(torch.int64)}, 1)
    with pytest.raises(ValueError):
        fused.rollout({**S, "fire": S["fire"].t().contiguous().t()}, 1)
    with pytest.raises(ValueError):
        fused.rollout(S, 1, tile=48)
    with pytest.raises(NotImplementedError):
        FusedFiremaker(FiremakerExMa(), mxu_stencil=True).rollout(S, 1)


def test_batched_env_on_the_card(dev):
    env = BatchedEnv("firemaker_ex_ma", batch_size=256, device=dev,
                     max_iterations=20)
    assert env.kernel == "fused_cuda"
    stats = env.rollout(15)
    assert stats["episodes"] == 256

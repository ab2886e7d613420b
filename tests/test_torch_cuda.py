"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device (checked inside the
fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance 0 for K1, K2, K4, K6 and K8 (at every lane group size), which are
built to be bit-equal to the plain versions (see ``ops/_cuda.py`` on ``--fmad=false``), with a linear
policy too; K4 (island_navigation_ex), K6 and K8 also under sustainability
regrowth and K8 in its gold and silver log rewards, where the kernel and the
plain version reach the same ``expf``/``logf``. K3, K5, K7 and K9 (the PPO collections) equal the plain collection in the integer state and records except on lanes whose site-0 uniform lies within 1e-6 of
a cumulative softmax sum (``expf``/``logf`` may round differently from
PyTorch's), and agrees within 1e-5 in logp, value and boot.
"""

import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs.boat_race import BoatRace
from ai_safety_gridworlds_torch.envs.boat_race_ex import BoatRaceEx
from ai_safety_gridworlds_torch.envs.firemaker_ex_ma import FiremakerExMa
from ai_safety_gridworlds_torch.envs.island_navigation import IslandNavigation
from ai_safety_gridworlds_torch.envs.island_navigation_ex_ma import (
    IslandNavigationExMa,
)
from ai_safety_gridworlds_torch.helpers.batched import BatchedEnv
from ai_safety_gridworlds_torch.learners import ppo_fused
from ai_safety_gridworlds_torch.ops import interop, prng
from ai_safety_gridworlds_torch.ops.fused_scalar import (
    FusedBoatRace,
    FusedBoatRaceEx,
    FusedIslandNav,
    fused_scalar_collect,
    fused_scalar_rollout,
)
from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops.fused_firemaker import (
    FusedFiremaker,
    fused_firemaker_collect,
    fused_firemaker_rollout,
)
from ai_safety_gridworlds_torch.ops.fused_island_ma import (
    FusedIslandMa,
    fused_island_ma_collect,
    fused_island_ma_rollout,
)
from ai_safety_gridworlds_torch.envs.aintelope_savanna import AIntelopeSavanna
from ai_safety_gridworlds_torch.ops.fused_savanna import (
    FusedSavanna,
    fused_savanna_collect,
    fused_savanna_rollout,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(a, b, lanes=None):
    """Exact equality, over the ``lanes`` mask of the last axis if given."""
    if not a.is_floating_point():
        a, b = a.to(torch.int64), b.to(torch.int64)
    if lanes is not None:
        a, b = a[..., lanes], b[..., lanes]
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
    # Ragged: 203 lanes are no multiple of the tile // 32 lanes per block.
    S0 = fused.init_packed(5, 203, dev)
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


ONE_AGENT = {"amount_agents": 1, **{
    k: '{"ENERGY": -1}' for k in ("SUPERVISOR_TRESPASSING_REWARD",
                                  "SUPERVISOR_STOP_BUTTON_REWARD",
                                  "SUPERVISOR_WORKSHOP_REWARD")}}


@pytest.mark.parametrize("kw", [
    ONE_AGENT, {}, {"amount_agents": 3},
], ids=["one_agent", "two_agents", "three_agents"])
@pytest.mark.parametrize("start", ["init", "busy"])
def test_rollout_kernel_matches_plain_per_agent_count(dev, kw, start):
    """Each agent count the kernel instantiates, at a ragged batch (8 lanes
    per block at tile 256) across auto-resets."""
    fused = FusedFiremaker(FiremakerExMa(max_iterations=30, **kw))
    B = 8 * 25 + 5
    S0 = (fused.init_packed(6, B, dev) if start == "init"
          else interop.busy_firemaker_state(fused, 6, B, dev))
    Sk = fused.rollout(S0, 50, tile=256)
    Sp = fused.rollout_plain(S0, 50)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].min()) >= 1


def _big_firemaker(monkeypatch):
    """Firemaker on its art widened to 33 x 33 = 1089 cells, past the
    kernels' 1024."""
    from ai_safety_gridworlds_torch.envs import firemaker_ex_ma as env_mod

    art = env_mod.GAME_ART[0]
    rows = [r[:-1] + ("#" if r[0] == r[1] == "#" else " ") * 16 + r[-1]
            for r in art[:-1]]
    rows += ["#" + " " * 31 + "#"] * 16 + ["#" * 33]
    monkeypatch.setattr(env_mod, "GAME_ART", env_mod.GAME_ART + [rows])
    return FusedFiremaker(FiremakerExMa(level=1))


def test_kernels_refuse_a_board_past_their_limit(dev, monkeypatch):
    fused = _big_firemaker(monkeypatch)
    S = fused.init_packed(0, 64, dev)
    before = (fused_firemaker_rollout.launches,
              fused_firemaker_collect.launches)
    with pytest.raises(ValueError, match="1024"):
        fused.rollout(S, 2)
    with pytest.raises(ValueError, match="1024"):
        fused.rollout_collect(S, _params(fused, dev, hidden=8), 2)
    assert (fused_firemaker_rollout.launches,
            fused_firemaker_collect.launches) == before
    assert int(fused.rollout_plain(S, 2)["t"].min()) == 4


def test_kernel_shared_memory_matches_python(dev):
    """The library's layout (fm_smem) and the wrapper's refusal check
    (_smem_bytes) agree."""
    import ctypes

    from ai_safety_gridworlds_torch.ops import fused_firemaker as fm

    lib = fm._firemaker_lib()
    lib.fm_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    for kw in ({}, {"amount_agents": 3,
                    "FIRE_SPREAD_EXCLUSIVE_MAX_DISTANCE": 4.0}):
        fused = FusedFiremaker(FiremakerExMa(**kw))
        p = fused._kernel_static(dev)
        for tile in (32, 96, 256):
            for hidden in (0, 1, 64):
                assert lib.fm_smem_bytes(ctypes.byref(p), fused.n, tile,
                                         hidden) == fm._smem_bytes(
                    fused, tile, hidden), (kw, tile, hidden)


def test_batched_env_on_the_card(dev):
    env = BatchedEnv("firemaker_ex_ma", batch_size=256, device=dev,
                     max_iterations=20)
    assert env.kernel == "fused_cuda"
    stats = env.rollout(15)
    assert stats["episodes"] == 256


def _policy(fused, B, seed):
    rng = np.random.default_rng(seed)
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    return (rng.normal(size=(B, A, F)), rng.normal(size=(B, A)),
            rng.uniform(0, 0.3, B))


@pytest.mark.parametrize("kw", [
    {}, {"action_direction_mode": 2, "observation_direction_mode": 1,
         "max_iterations": 30},
    {"amount_agents": 3, "max_iterations": 30},
], ids=["default", "dirs", "three_agents"])
def test_linear_policy_kernel_matches_plain_across_a_swap(dev, kw):
    """K1's linear branch, then a new policy and a shared one installed
    after the first launch, then removal: each reaches the next launch."""
    fused = FusedFiremaker(FiremakerExMa(**kw))
    B = 200
    S0 = interop.busy_firemaker_state(fused, 3, B, dev)
    A = fused.amax - fused.amin + 1
    finals = []
    for pol in (_policy(fused, B, 1), _policy(fused, B, 2),
                (np.ones((A, 6)), np.arange(A, dtype=np.float32), 0.0)):
        fused.set_policies(*pol)
        Sk = fused.rollout(S0, 40)
        Sp = fused.rollout_plain(S0, 40)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), k
        finals.append(Sk["pos"])
    assert not torch.equal(finals[0], finals[1])
    fused.set_policies(None, None)
    Sk, Sp = fused.rollout(S0, 40), fused.rollout_plain(S0, 40)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k


def _params(fused, dev, hidden=64, seed=0):
    rng = np.random.default_rng(seed)
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    return interop.params_from_numpy({
        "mlp_w1": rng.normal(size=(hidden, F)) / np.sqrt(F),
        "mlp_b1": rng.normal(size=(hidden, 1)) * 0.1,
        "mlp_w2": rng.normal(size=(A + 1, hidden)) * 0.3,
        "mlp_b2": rng.normal(size=(A + 1, 1)) * 0.1,
    }, dev)


@pytest.mark.parametrize("kw", [
    {}, {"action_direction_mode": 1, "max_iterations": 12},
    {"amount_agents": 3, "max_iterations": 12},
], ids=["default", "dirs_reset", "three_agents"])
def test_collect_kernel_matches_plain_teacher_forced(dev, kw):
    fused = FusedFiremaker(FiremakerExMa(**kw))
    B = 256
    params = _params(fused, dev)
    S = interop.busy_firemaker_state(fused, 4, B, dev)
    statics = fused._collect_statics(S, params)
    exempt = 0
    for step in range(16):
        before = fused_firemaker_collect.launches
        Sk, tk, bk = fused.rollout_collect(S, params, 1)
        assert fused_firemaker_collect.launches == before + 1
        Sp, rec, ex = fused._collect_step(S, statics)
        keep = ~(ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        exempt += int((~keep).sum())
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k], keep), (step, k)
        for k in ("feats", "action", "reward", "done"):
            assert _equal(tk[k][0], rec[k], keep), (step, k)
        torch.testing.assert_close(tk["logp"][0][:, keep], rec["logp"][:, keep],
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(tk["value"][0], rec["value"], rtol=0,
                                   atol=1e-5)
        boot = fused._bootstrap_value(Sp, statics)
        torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0,
                                   atol=1e-5)
        S = Sp
    assert exempt <= 2


@pytest.mark.parametrize("kw", [ONE_AGENT, {"amount_agents": 3}],
                         ids=["one_agent", "three_agents"])
def test_collect_kernel_matches_plain_at_a_ragged_batch(dev, kw):
    """K3 at 8 * 25 + 5 lanes (tile 256: 8 lanes per block) within phase
    7's limits: teacher-forced, every non-exempt lane equal, logp, value and
    boot within 1e-5."""
    fused = FusedFiremaker(FiremakerExMa(max_iterations=12, **kw))
    B = 8 * 25 + 5
    params = _params(fused, dev, hidden=40)
    S = interop.busy_firemaker_state(fused, 7, B, dev)
    statics = fused._collect_statics(S, params)
    exempt = 0
    for step in range(16):
        Sk, tk, bk = fused.rollout_collect(S, params, 1, tile=256)
        Sp, rec, ex = fused._collect_step(S, statics)
        keep = ~(ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        exempt += int((~keep).sum())
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k], keep), (step, k)
        for k in ("feats", "action", "reward", "done"):
            assert _equal(tk[k][0], rec[k], keep), (step, k)
        torch.testing.assert_close(tk["logp"][0][:, keep],
                                   rec["logp"][:, keep], rtol=0, atol=1e-5)
        torch.testing.assert_close(tk["value"][0], rec["value"], rtol=0,
                                   atol=1e-5)
        boot = fused._bootstrap_value(Sp, statics)
        torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0,
                                   atol=1e-5)
        S = Sp
    assert exempt <= 2


def test_collect_kernel_rejects_bad_params(dev):
    fused = FusedFiremaker(FiremakerExMa())
    S = fused.init_packed(0, 64, dev)
    params = _params(fused, dev, hidden=16)
    bad = [
        {**params, "mlp_w1": params["mlp_w1"][:, :5].contiguous()},
        {**params, "mlp_b1": params["mlp_b1"].double()},
        {**params, "mlp_w2": params["mlp_w2"].cpu()},
        {**params, "mlp_b2": params["mlp_b2"][:5].contiguous()},
        {**params, "mlp_w2": params["mlp_w2"].t().contiguous().t()},
        {k: v for k, v in params.items() if k != "mlp_b1"},
    ]
    before = fused_firemaker_collect.launches
    for p in bad:
        with pytest.raises(ValueError):
            fused.rollout_collect(S, p, 2)
    with pytest.raises(ValueError):
        fused.rollout_collect(S, _params(fused, dev, hidden=20000), 2)
    assert fused_firemaker_collect.launches == before
    _, traj, boot = fused.rollout_collect(S, params, 0)
    assert traj["action"].shape == (0, 2, 64) and boot.shape == (2, 64)


def test_train_step_on_the_card_moves_the_params(dev):
    fused = FusedFiremaker(FiremakerExMa(max_iterations=20))
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(fused, 256, seed=1, config=config,
                                       device="cuda")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = ppo_fused.make_train_step(fused, config, device="cuda")
    before = fused_firemaker_collect.launches
    state, metrics = step(state)
    assert fused_firemaker_collect.launches == before + 1
    assert state.update_idx == 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    moved = max(float((state.params[k].detach() - p0[k]).abs().max())
                for k in p0)
    assert moved > 0
    assert state.S["t"].is_cuda


SCALAR = {
    "boat_race": lambda **kw: FusedBoatRace(BoatRace(**kw)),
    "island_navigation": lambda **kw: FusedIslandNav(IslandNavigation(**kw)),
    "boat_race_ex": lambda **kw: FusedBoatRaceEx(BoatRaceEx(**kw)),
    "boat_race_ex_l3": lambda **kw: FusedBoatRaceEx(
        BoatRaceEx(level=3, noops=False, **kw)),
}


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("name", sorted(SCALAR))
@pytest.mark.parametrize("tile", [32, 128])
def test_scalar_rollout_kernel_matches_plain(dev, name, start, tile):
    fused = SCALAR[name](max_iterations=20)
    B = 200  # ragged: 200 is no multiple of tile
    if start == "init":
        S0 = fused.init_packed(5, B, dev)
    else:
        S0 = interop.busy_scalar_state(fused, 5, B, dev)
    before = fused_scalar_rollout.launches
    Sk = fused.rollout(S0, 70, tile=tile)
    assert fused_scalar_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 70)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    if start == "busy":
        assert int(Sk["draw_ctr"].to(torch.int64).min()) < 70  # wrapped


@pytest.mark.parametrize("name", ["island_navigation", "boat_race_ex"])
def test_scalar_linear_policy_kernel_matches_plain(dev, name):
    fused = SCALAR[name](max_iterations=30)
    B = 200
    S0 = interop.busy_scalar_state(fused, 3, B, dev)
    finals = []
    for seed in (1, 2):
        fused.set_policies(*_policy(fused, B, seed))
        Sk, Sp = fused.rollout(S0, 50), fused.rollout_plain(S0, 50)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), k
        finals.append(Sk["pos"])
    assert not torch.equal(finals[0], finals[1])
    fused.set_policies(None, None)


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_collect_kernel_matches_plain(dev, name):
    fused = SCALAR[name](max_iterations=25)
    B = 256
    params = _params(fused, dev)
    S0 = interop.busy_scalar_state(fused, 4, B, dev)
    before = fused_scalar_collect.launches
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    assert fused_scalar_collect.launches == before + 1
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(B, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


@pytest.mark.parametrize("lanes", [32, 16, 8])
@pytest.mark.parametrize("name,kw", [
    ("side_effects_sokoban", {"level": 1}), ("conveyor_belt_ex", {}),
    ("boat_race_ex", {}), ("tomato_watering", {}),
], ids=["sokoban_l1", "conveyor_belt_ex", "boat_race_ex", "tomato"])
def test_scalar_kernels_with_fewer_lanes_a_warp(dev, monkeypatch, name, kw,
                                                lanes):
    """K4 and K5 with 32, 16 or 8 of each warp's threads running a lane
    (the others return after the table load) at a ragged B and two tiles:
    K4 equal to the plain version, K5 equal to K5 at 32 lanes a warp."""
    from ai_safety_gridworlds_torch.ops import fused_scalar

    env = factory.get_raw_env(name, **kw)
    env.max_iterations = 20
    fused = tops.make_fused(env)
    B = 203
    S0 = interop.busy_scalar_state(fused, 6, B, dev)
    params = _params(fused, dev, hidden=16)
    monkeypatch.setattr(fused_scalar, "_LANES_PER_WARP", 32)
    ref = fused.rollout_collect(S0, params, 30)
    monkeypatch.setattr(fused_scalar, "_LANES_PER_WARP", lanes)
    Sp = fused.rollout_plain(S0, 70)
    for tile in (32, 64):
        Sk = fused.rollout(S0, 70, tile=tile)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), (tile, k)
    S, traj, boot = fused.rollout_collect(S0, params, 30)
    for k in fused.STATE_FIELDS:
        assert _equal(S[k], ref[0][k]), k
    for k in traj:
        assert _equal(traj[k], ref[1][k]), k
    assert _equal(boot, ref[2])


def test_scalar_lanes_per_warp_follow_the_batch(dev):
    """The default lanes a warp: 8 while ceil(B / 8) warps fit the card's
    schedulers, then 16, then 32; never fewer than tile / 8."""
    from ai_safety_gridworlds_torch.ops import fused_scalar

    slots = fused_scalar._schedulers(str(dev))
    assert slots == 4 * torch.cuda.get_device_properties(
        dev).multi_processor_count
    pick = fused_scalar._lanes_per_warp
    assert pick(8 * slots, 32, dev) == 8
    assert pick(8 * slots + 1, 32, dev) == 16
    assert pick(16 * slots, 32, dev) == 16
    assert pick(16 * slots + 1, 32, dev) == 32
    assert pick(64, 256, dev) == 32 and pick(64, 128, dev) == 16


def test_scalar_kernels_reject_bad_inputs(dev):
    fused = SCALAR["boat_race_ex"]()
    S = fused.init_packed(0, 64, dev)
    before = fused_scalar_rollout.launches
    with pytest.raises(ValueError):
        fused.rollout({**S, "visits": S["visits"][:-1].contiguous()}, 1)
    with pytest.raises(ValueError):
        fused.rollout({**S, "ep_ret": S["ep_ret"].double()}, 1)
    with pytest.raises(ValueError):
        fused.rollout(S, 1, tile=48)
    assert fused_scalar_rollout.launches == before
    with pytest.raises(ValueError):
        fused.rollout_collect(S, _params(fused, dev, hidden=20000), 2)
    assert fused.rollout(S, 0)["visits"].equal(S["visits"])


@pytest.mark.parametrize("name", ["boat_race", "boat_race_ex"])
def test_scalar_train_step_on_the_card(dev, name):
    fused = SCALAR[name](max_iterations=20)
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(fused, 256, seed=1, config=config,
                                       device="cuda")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = ppo_fused.make_train_step(fused, config, device="cuda")
    before = fused_scalar_collect.launches
    state, metrics = step(state)
    assert fused_scalar_collect.launches == before + 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    assert max(float((state.params[k].detach() - p0[k]).abs().max())
               for k in p0) > 0


@pytest.mark.parametrize("name", ["boat_race", "island_navigation",
                                  "boat_race_ex"])
def test_scalar_batched_env_on_the_card(dev, name):
    env = BatchedEnv(name, batch_size=256, device=dev, max_iterations=10)
    before = fused_scalar_rollout.launches
    stats = env.rollout(22)  # 10 steps + reset, twice: >= 2 episodes a lane
    assert fused_scalar_rollout.launches == before + 1
    assert env.kernel == "fused_cuda" and stats["episodes"] >= 512


# island_navigation_ex and the bodies with a per-episode draw: (name, env
# kwargs) by id.
SCALAR_NEW = {
    "island_navigation_ex": ("island_navigation_ex", {}),
    "island_navigation_ex_full": ("island_navigation_ex", dict(
        level=3, sustainability_challenge=True, thirst_hunger_death=True,
        penalise_oversatiation=True, use_satiation_proportional_reward=True)),
    "island_navigation_ex_l4": ("island_navigation_ex", {
        "level": 4, "sustainability_challenge": False}),
    "absent_supervisor": ("absent_supervisor", {}),
    "absent_supervisor_pinned": ("absent_supervisor", {"supervisor": True}),
    "distributional_shift": ("distributional_shift", {}),
    "distributional_shift_testing": ("distributional_shift",
                                     {"is_testing": True}),
    "safe_interruptibility": ("safe_interruptibility", {}),
    "safe_interruptibility_l0_p1": ("safe_interruptibility", {
        "level": 0, "interruption_probability": 1.0}),
    "safe_interruptibility_ex": ("safe_interruptibility_ex", {}),
}


def _scalar_new(case, max_iterations=20):
    name, kw = SCALAR_NEW[case]
    env = factory.get_raw_env(name, **kw)
    env.max_iterations = max_iterations  # short episodes: many reset draws
    return tops.make_fused(env)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", sorted(SCALAR_NEW))
@pytest.mark.parametrize("tile", [32, 128])
def test_new_scalar_rollout_kernel_matches_plain(dev, case, start, tile):
    """K4 on island_navigation_ex (regrowth through expf/logf included) and
    the reset-draw bodies: every field equal to the plain version."""
    fused = _scalar_new(case)
    B = 200
    if start == "init":
        S0 = fused.init_packed(5, B, dev)
    else:
        S0 = interop.busy_scalar_state(fused, 5, B, dev)
    before = fused_scalar_rollout.launches
    Sk = fused.rollout(S0, 70, tile=tile)
    assert fused_scalar_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 70)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    if start == "busy":
        assert int(Sk["draw_ctr"].to(torch.int64).min()) < 70  # wrapped


@pytest.mark.parametrize("case", ["island_navigation_ex",
                                  "safe_interruptibility"])
def test_new_scalar_linear_policy_kernel_matches_plain(dev, case):
    fused = _scalar_new(case, max_iterations=30)
    B = 200
    S0 = interop.busy_scalar_state(fused, 3, B, dev)
    fused.set_policies(*_policy(fused, B, 1))
    Sk, Sp = fused.rollout(S0, 50), fused.rollout_plain(S0, 50)
    fused.set_policies(None, None)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k


@pytest.mark.parametrize("case", sorted(SCALAR_NEW))
def test_new_scalar_collect_kernel_matches_plain(dev, case):
    """K5 within phase 7's limits: equal except on lanes whose draw lies
    within 1e-6 of a CDF boundary; logp, value and boot within 1e-5."""
    fused = _scalar_new(case, max_iterations=25)
    B = 256
    params = _params(fused, dev)
    S0 = interop.busy_scalar_state(fused, 4, B, dev)
    before = fused_scalar_collect.launches
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    assert fused_scalar_collect.launches == before + 1
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(B, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["island_navigation_ex", "absent_supervisor",
                                  "distributional_shift",
                                  "safe_interruptibility",
                                  "safe_interruptibility_ex"])
def test_new_scalar_batched_env_and_train_step_on_the_card(dev, name):
    env = BatchedEnv(name, batch_size=256, device=dev)
    before = fused_scalar_rollout.launches
    stats = env.rollout(210)  # truncation at 100: episodes in every lane
    assert fused_scalar_rollout.launches == before + 1
    assert env.kernel == "fused_cuda" and stats["episodes"] >= 512
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(env.fused, 256, seed=1, config=config,
                                       device="cuda")
    step = ppo_fused.make_train_step(env.fused, config, device="cuda")
    before = fused_scalar_collect.launches
    state, metrics = step(state)
    assert fused_scalar_collect.launches == before + 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k


def test_scalar_kernels_refuse_a_physics_draw(dev):
    """A physics draw of more rows than K4/K5 take (PHYS_ROWS > 16) is
    refused before any launch."""
    fused = _scalar_new("absent_supervisor")
    S = fused.init_packed(0, 64, dev)
    fused.PHYS_ROWS, fused.n_sites = 17, 3
    before = fused_scalar_rollout.launches, fused_scalar_collect.launches
    with pytest.raises(NotImplementedError, match="PHYS_ROWS"):
        fused.rollout(S, 1)
    with pytest.raises(NotImplementedError, match="PHYS_ROWS"):
        fused.rollout_collect(S, _params(fused, dev), 1)
    assert (fused_scalar_rollout.launches,
            fused_scalar_collect.launches) == before


# The last scalar slice's bodies, the cases of tests/test_fused_scalar.py:
# (name, env kwargs) by id.
SCALAR_LAST = {
    "sokoban_l0": ("side_effects_sokoban", {}),
    "sokoban_l1_noops": ("side_effects_sokoban", {"level": 1, "noops": True}),
    "sokoban_l2": ("side_effects_sokoban", {"level": 2}),
    "sokoban_l3": ("side_effects_sokoban", {"level": 3}),
    "whisky_gold": ("whisky_gold", {}),
    "tomato_watering": ("tomato_watering", {}),
    "tomato_crmdp": ("tomato_crmdp", {}),
    "conveyor_vase": ("conveyor_belt", {"variant": "vase"}),
    "conveyor_sushi": ("conveyor_belt", {"variant": "sushi"}),
    "conveyor_sushi_goal": ("conveyor_belt", {"variant": "sushi_goal",
                                              "noops": True}),
    "conveyor_sushi_goal2": ("conveyor_belt", {"variant": "sushi_goal2"}),
    "rocks_l0": ("rocks_diamonds", {}),
    "rocks_l1": ("rocks_diamonds", {"level": 1}),
    "conveyor_ex_vase": ("conveyor_belt_ex", {"variant": "vase"}),
    "conveyor_ex_sushi_goal": ("conveyor_belt_ex", {"variant": "sushi_goal",
                                                    "noops": True}),
    "friend_foe": ("friend_foe", {}),
    "friend_foe_friend": ("friend_foe", {"bandit_type": "friend"}),
    "friend_foe_adversary_extra": ("friend_foe", {"bandit_type": "adversary",
                                                  "extra_step": True}),
}


def _scalar_last(case, max_iterations=20):
    name, kw = SCALAR_LAST[case]
    env = factory.get_raw_env(name, **kw)
    env.max_iterations = max_iterations  # short episodes: many resets
    return tops.make_fused(env)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", sorted(SCALAR_LAST))
@pytest.mark.parametrize("tile", [32, 128])
def test_last_scalar_rollout_kernel_matches_plain(dev, case, start, tile):
    """K4 on the last slice's bodies (the coin board in shared memory,
    tomato's 13-row draws at sites 1 and 2, friend_foe's two-row reset draw
    and IEEE division): every field equal to the plain version."""
    fused = _scalar_last(case)
    B = 200
    if start == "init":
        S0 = fused.init_packed(5, B, dev)
    else:
        S0 = interop.busy_scalar_state(fused, 5, B, dev)
    before = fused_scalar_rollout.launches
    Sk = fused.rollout(S0, 70, tile=tile)
    assert fused_scalar_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 70)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    if start == "busy":
        assert int(Sk["draw_ctr"].to(torch.int64).min()) < 70  # wrapped


@pytest.mark.parametrize("case", ["sokoban_l1_noops", "tomato_watering",
                                  "rocks_l0", "friend_foe"])
def test_last_scalar_linear_policy_kernel_matches_plain(dev, case):
    fused = _scalar_last(case, max_iterations=30)
    B = 200
    S0 = interop.busy_scalar_state(fused, 3, B, dev)
    fused.set_policies(*_policy(fused, B, 1))
    Sk, Sp = fused.rollout(S0, 50), fused.rollout_plain(S0, 50)
    fused.set_policies(None, None)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k


@pytest.mark.parametrize("case", sorted(SCALAR_LAST))
def test_last_scalar_collect_kernel_matches_plain(dev, case):
    """K5 within phase 7's limits: equal except on lanes whose draw lies
    within 1e-6 of a CDF boundary; logp, value and boot within 1e-5."""
    fused = _scalar_last(case, max_iterations=25)
    B = 256
    params = _params(fused, dev)
    S0 = interop.busy_scalar_state(fused, 4, B, dev)
    before = fused_scalar_collect.launches
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    assert fused_scalar_collect.launches == before + 1
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(B, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["side_effects_sokoban", "whisky_gold",
                                  "tomato_watering", "conveyor_belt_sushi_goal2",
                                  "rocks_diamonds", "friend_foe",
                                  "conveyor_belt_ex"])
def test_last_scalar_batched_env_and_train_step_on_the_card(dev, name):
    env = BatchedEnv(name, batch_size=256, device=dev)
    before = fused_scalar_rollout.launches
    stats = env.rollout(210)  # truncation at 100: episodes in every lane
    assert fused_scalar_rollout.launches == before + 1
    assert env.kernel == "fused_cuda" and stats["episodes"] >= 512
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(env.fused, 256, seed=1, config=config,
                                       device="cuda")
    step = ppo_fused.make_train_step(env.fused, config, device="cuda")
    before = fused_scalar_collect.launches
    state, metrics = step(state)
    assert fused_scalar_collect.launches == before + 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k


# tests/test_fused_island_ma.py's rich configuration.
ISLAND_RICH = dict(level=3, sustainability_challenge=True,
                   thirst_hunger_death=True, penalise_oversatiation=True,
                   use_satiation_proportional_reward=True)
# (id, env kwargs, layout pool, start)
ISLAND = [
    ("default", {"max_iterations": 40}, 1, "init"),
    ("rich", dict(ISLAND_RICH, max_iterations=40), 1, "init"),
    ("pool3", {"map_randomization_frequency": 1, "max_iterations": 20}, 3,
     "init"),
    ("busy", {}, 1, "busy"),
    ("busy_pool3", {"map_randomization_frequency": 2, "max_iterations": 30},
     3, "busy"),
    ("one_agent", {"level": 10, "amount_agents": 1, "max_iterations": 25}, 1,
     "init"),
    ("fixed_dirs", {"action_direction_mode": 0, "observation_direction_mode": 0,
                    "max_iterations": 30}, 1, "init"),
    ("turn_dirs", {"action_direction_mode": 2, "observation_direction_mode": 2,
                   "max_iterations": 30}, 1, "init"),
]


def _island(kw, K, start, dev, B=200, seed=5):
    fused = FusedIslandMa(IslandNavigationExMa(**kw))
    if start == "init":
        return fused, fused.init_packed(seed, B, dev, layout_pool=K)
    fused.layout_pool = K
    return fused, interop.busy_island_ma_state(fused, seed, B, dev)


@pytest.mark.parametrize("case", ISLAND, ids=[c[0] for c in ISLAND])
@pytest.mark.parametrize("tile", [32, 128])
def test_island_rollout_kernel_matches_plain(dev, case, tile):
    _, kw, K, start = case
    fused, S0 = _island(kw, K, start, dev)  # ragged: 200 lanes
    before = fused_island_ma_rollout.launches
    Sk = fused.rollout(S0, 90, tile=tile)
    assert fused_island_ma_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 90)
    for k in fused.STATE_FIELDS:
        assert Sk[k].dtype == Sp[k].dtype, k
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    if start == "busy":
        assert int(Sk["draw_ctr"].to(torch.int64).min()) < 90  # wrapped


def test_island_linear_policy_kernel_matches_plain_across_a_swap(dev):
    fused, S0 = _island({"max_iterations": 30}, 1, "busy", dev, seed=3)
    B = S0["t"].shape[1]
    finals = []
    for seed in (1, 2):
        fused.set_policies(*_policy(fused, B, seed))
        Sk, Sp = fused.rollout(S0, 60), fused.rollout_plain(S0, 60)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), k
        finals.append(Sk["pos"])
    assert not torch.equal(finals[0], finals[1])
    fused.set_policies(None, None)
    Sk, Sp = fused.rollout(S0, 60), fused.rollout_plain(S0, 60)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k


@pytest.mark.parametrize("start", ["init", "busy"])
def test_island_collect_kernel_matches_plain(dev, start):
    fused, S0 = _island({"max_iterations": 30}, 1, start, dev, B=256, seed=4)
    params = _params(fused, dev)
    before = fused_island_ma_collect.launches
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    assert fused_island_ma_collect.launches == before + 1
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(256, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


ISLAND_GROUPS = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("case", ISLAND, ids=[c[0] for c in ISLAND])
def test_island_rollout_kernel_matches_plain_at_every_group(dev, case,
                                                            monkeypatch):
    """K6 with g threads a lane, at the default block and at 64 threads."""
    from ai_safety_gridworlds_torch.ops import fused_island_ma

    _, kw, K, start = case
    fused, S0 = _island(kw, K, start, dev)  # ragged: 200 lanes
    Sp = fused.rollout_plain(S0, 60)
    for g in ISLAND_GROUPS:
        monkeypatch.setattr(fused_island_ma, "_LANES_PER_GROUP", g)
        for tile in (None, 64):
            Sk = fused.rollout(S0, 60, tile=tile)
            for k in fused.STATE_FIELDS:
                assert _equal(Sk[k], Sp[k]), (g, tile, k)


@pytest.mark.parametrize("g", ISLAND_GROUPS)
def test_island_collect_kernel_matches_plain_at_every_group(dev, g,
                                                            monkeypatch):
    from ai_safety_gridworlds_torch.ops import fused_island_ma

    monkeypatch.setattr(fused_island_ma, "_LANES_PER_GROUP", g)
    fused, S0 = _island({"max_iterations": 30}, 1, "busy", dev, B=256, seed=4)
    params = _params(fused, dev)
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(256, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


def test_island_smem_bytes_match_the_library(dev):
    import ctypes

    from ai_safety_gridworlds_torch.ops import fused_island_ma

    lib = fused_island_ma._island_lib()
    for kw, K in (({}, 1), (ISLAND_RICH, 1),
                  ({"map_randomization_frequency": 1}, 3),
                  ({"level": 10, "amount_agents": 1}, 1)):
        fused, S = _island(kw, K, "init", dev, B=64)
        out = {k: torch.empty_like(S[k]) for k in fused.STATE_FIELDS}
        p = fused_island_ma._params(fused, S, out, dev)
        for g in ISLAND_GROUPS:
            p.group = g
            for threads in (32, 128, 256):
                for hidden in (0, 64):
                    assert lib.im_smem_bytes(ctypes.byref(p), fused.n, threads,
                                             hidden) == \
                        fused_island_ma._smem_bytes(fused, g, threads, hidden)


def test_island_kernels_reject_bad_inputs(dev):
    fused, S = _island({"map_randomization_frequency": 1}, 1, "init", dev,
                       B=64)
    before = fused_island_ma_rollout.launches
    with pytest.raises(ValueError):
        fused.rollout({**S, "vcode": S["vcode"].double()}, 1)
    with pytest.raises(ValueError):
        fused.rollout({**S, "pos": S["pos"].t().contiguous().t()}, 1)
    with pytest.raises(ValueError):
        fused.rollout(S, 1, tile=48)
    other = fused.init_packed(0, 32, dev)  # per-lane layouts for 32 lanes
    with pytest.raises(ValueError):
        fused.rollout(S, 1)
    assert fused_island_ma_rollout.launches == before
    with pytest.raises(ValueError):
        fused.rollout_collect(other, _params(fused, dev, hidden=20000), 2)
    assert torch.equal(fused.rollout(other, 0)["pos"], other["pos"])


def test_island_batched_env_and_train_step_on_the_card(dev):
    env = BatchedEnv("island_navigation_ex_ma", batch_size=256, device=dev,
                     max_iterations=10)
    before = fused_island_ma_rollout.launches
    stats = env.rollout(12)  # t counts 2 sub-steps a step: 5 steps + reset
    assert fused_island_ma_rollout.launches == before + 1
    assert env.kernel == "fused_cuda" and stats["episodes"] >= 256
    fused = FusedIslandMa(IslandNavigationExMa(max_iterations=20))
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(fused, 256, seed=1, config=config,
                                       device="cuda")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = ppo_fused.make_train_step(fused, config, device="cuda")
    before = fused_island_ma_collect.launches
    state, metrics = step(state)
    assert fused_island_ma_collect.launches == before + 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    assert max(float((state.params[k].detach() - p0[k]).abs().max())
               for k in p0) > 0


# Level 0 with every savanna feature its art holds.
SAVANNA_FULL = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
SAVANNA_RICH = dict(
    level=13, amount_agents=2, amount_predators=2, amount_drink_holes=2,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_water_tiles=2,
    penalise_oversatiation=True, thirst_hunger_death=True,
)
# (id, env kwargs, init_packed kwargs, start)
SAVANNA = [
    ("default", {"max_iterations": 20}, {}, "init"),
    ("sustain", {"sustainability_challenge": True, "max_iterations": 20}, {},
     "init"),
    ("full", dict(SAVANNA_FULL, max_iterations=20), {}, "init"),
    ("full_sustain", dict(SAVANNA_FULL, sustainability_challenge=True,
                          max_iterations=20), {}, "init"),
    ("rich", dict(SAVANNA_RICH, max_iterations=12), {}, "init"),
    ("pool3", dict(SAVANNA_FULL, map_randomization_frequency=1,
                   max_iterations=10), {"layout_pool": 3}, "init"),
    ("no_exact_reset", dict(SAVANNA_FULL, max_iterations=10),
     {"exact_reset": False}, "init"),
    ("busy", {}, {}, "busy"),
    ("busy_full_sustain", dict(SAVANNA_FULL, sustainability_challenge=True),
     {}, "busy"),
]


def _savanna(kw, pack, start, dev, B=200, seed=5):
    fused = FusedSavanna(AIntelopeSavanna(**kw))
    S = fused.init_packed(seed, B, dev, **pack)
    if start == "busy":
        S = interop.busy_savanna_state(fused, seed, B, dev)
    return fused, S


@pytest.mark.parametrize("case", SAVANNA, ids=[c[0] for c in SAVANNA])
@pytest.mark.parametrize("tile", [32, 128])
def test_savanna_rollout_kernel_matches_plain(dev, case, tile):
    _, kw, pack, start = case
    fused, S0 = _savanna(kw, pack, start, dev)  # ragged: 200 lanes
    before = fused_savanna_rollout.launches
    Sk = fused.rollout(S0, 60, tile=tile)
    assert fused_savanna_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 60)
    for k in fused.STATE_FIELDS:
        assert Sk[k].dtype == Sp[k].dtype, k
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    if start == "busy":
        assert int(Sk["draw_ctr"].to(torch.int64).min()) < 60  # wrapped


@pytest.mark.parametrize("g,lanes", [(1, None), (1, 8), (2, None), (4, None),
                                     (8, None), (16, None), (32, None)])
@pytest.mark.parametrize("case", [c for c in SAVANNA if c[0] in (
    "sustain", "full_sustain", "pool3", "busy_full_sustain")],
    ids=["sustain", "full_sustain", "pool3", "busy_full_sustain"])
def test_savanna_rollout_kernel_matches_plain_at_every_group(dev, case, g,
                                                             lanes,
                                                             monkeypatch):
    """K8 with g threads a lane (and with 8 lanes a warp at g = 1, the
    other threads idle), at the default block and at 64 threads."""
    from ai_safety_gridworlds_torch.ops import fused_savanna

    _, kw, pack, start = case
    fused, S0 = _savanna(kw, pack, start, dev)  # ragged: 200 lanes
    monkeypatch.setattr(fused_savanna, "_LANES_PER_GROUP", g)
    monkeypatch.setattr(fused_savanna, "_LANES_PER_WARP", lanes)
    Sp = fused.rollout_plain(S0, 60)
    for tile in (None, 64):
        Sk = fused.rollout(S0, 60, tile=tile)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), (tile, k)


def test_savanna_lane_bytes_match_the_library(dev):
    import ctypes

    from ai_safety_gridworlds_torch.ops import fused_savanna

    lib = fused_savanna._savanna_lib()
    for kw in ({}, {"sustainability_challenge": True}, SAVANNA_FULL,
               dict(SAVANNA_FULL, sustainability_challenge=True),
               {"amount_agents": 5}, {"amount_agents": 10},
               dict(SAVANNA_FULL, amount_agents=10,
                    sustainability_challenge=True)):
        fused, _ = _savanna(kw, {}, "init", dev, B=8)
        p = fused_savanna._static_params(fused, fused._on(dev))
        assert lib.sv_lane_bytes(ctypes.byref(p)) == fused_savanna._lane_bytes(fused)


def test_savanna_linear_policy_kernel_matches_plain_across_a_swap(dev):
    fused, S0 = _savanna(dict(SAVANNA_FULL, max_iterations=30), {}, "busy",
                         dev, seed=3)
    B = S0["t"].shape[1]
    finals = []
    for seed in (1, 2):
        fused.set_policies(*_policy(fused, B, seed))
        Sk, Sp = fused.rollout(S0, 40), fused.rollout_plain(S0, 40)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), k
        finals.append(Sk["pos"])
    assert not torch.equal(finals[0], finals[1])
    fused.set_policies(None, None)


# K8's agent counts beyond the two of SAVANNA: 3..10 run the wide kernel
# (csrc/fused_savanna.cu, the agents' rows in shared memory, SvRows).
# The level's art holds two agents and parks the others at cell 0; a
# resized map holds every agent (and redraws, or with a layout pool
# randomizes the maps on the host).
SAVANNA_RESIZED = {"map_width": 15, "map_height": 15}
# (id, env kwargs, init_packed kwargs)
SAVANNA_AGENTS = [
    ("n3", {"amount_agents": 3, "max_iterations": 20}, {}),
    ("n4", {"amount_agents": 4, "max_iterations": 20}, {}),
    ("n5", {"amount_agents": 5, "max_iterations": 20}, {}),
    ("n10", {"amount_agents": 10, "max_iterations": 30}, {}),
    ("n5_sustain", {"amount_agents": 5, "sustainability_challenge": True,
                    "max_iterations": 20}, {}),
    ("n7_full_sustain", dict(SAVANNA_FULL, amount_agents=7,
                             sustainability_challenge=True,
                             max_iterations=30), {}),
    ("n10_full_sustain", dict(SAVANNA_FULL, amount_agents=10,
                              sustainability_challenge=True,
                              max_iterations=30), {}),
    ("n10_resized", dict(SAVANNA_RESIZED, amount_agents=10,
                         max_iterations=30), {}),
    ("n6_resized_pool3", dict(SAVANNA_RESIZED, amount_agents=6,
                              map_randomization_frequency=1,
                              max_iterations=20), {"layout_pool": 3}),
]


@pytest.mark.parametrize("case", SAVANNA_AGENTS,
                         ids=[c[0] for c in SAVANNA_AGENTS])
@pytest.mark.parametrize("start", ["init", "busy"])
def test_savanna_rollout_kernel_matches_plain_at_n_agents(dev, case, start,
                                                          monkeypatch):
    """K8 at 3..10 agents equal to the plain rollout in every field, at the
    picked lane group and at 1 and 32 threads a lane, across auto-resets."""
    from ai_safety_gridworlds_torch.ops import fused_savanna

    _, kw, pack = case
    fused, S0 = _savanna(kw, pack, start, dev)  # ragged: 200 lanes
    before = fused_savanna_rollout.launches
    Sk = fused.rollout(S0, 60)
    assert fused_savanna_rollout.launches == before + 1
    Sp = fused.rollout_plain(S0, 60)
    for k in fused.STATE_FIELDS:
        assert Sk[k].dtype == Sp[k].dtype, k
        assert _equal(Sk[k], Sp[k]), k
    assert int(Sk["stats_episodes"].sum()) > int(S0["stats_episodes"].sum())
    for g in (1, 32):
        monkeypatch.setattr(fused_savanna, "_LANES_PER_GROUP", g)
        Sk = fused.rollout(S0, 60)
        for k in fused.STATE_FIELDS:
            assert _equal(Sk[k], Sp[k]), (g, k)


def test_savanna_wide_linear_policy_kernel_matches_plain(dev):
    fused, S0 = _savanna(dict(SAVANNA_FULL, amount_agents=6,
                              max_iterations=30), {}, "busy", dev, seed=3)
    fused.set_policies(*_policy(fused, S0["t"].shape[1], 1))
    Sk, Sp = fused.rollout(S0, 40), fused.rollout_plain(S0, 40)
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], Sp[k]), k
    fused.set_policies(None, None)


@pytest.mark.parametrize("start", ["init", "busy"])
def test_savanna_collect_kernel_matches_plain(dev, start):
    _check_savanna_collect(dev, dict(SAVANNA_FULL, max_iterations=30), start)


@pytest.mark.parametrize("kw", [
    {"amount_agents": 5, "max_iterations": 30},
    dict(SAVANNA_FULL, amount_agents=5, max_iterations=30),
], ids=["n5", "n5_full"])
@pytest.mark.parametrize("start", ["init", "busy"])
def test_savanna_collect_kernel_matches_plain_at_five_agents(dev, kw, start):
    _check_savanna_collect(dev, kw, start)


def _check_savanna_collect(dev, kw, start):
    """K9 against the plain collection, teacher-forced: the lanes whose
    draw came within 1e-6 of a CDF step are left out (at most 2)."""
    fused, S0 = _savanna(kw, {}, start, dev, B=256, seed=4)
    params = _params(fused, dev)
    before = fused_savanna_collect.launches
    Sk, tk, bk = fused.rollout_collect(S0, params, 40)
    assert fused_savanna_collect.launches == before + 1
    statics = fused._collect_statics(S0, params)
    S, exempt = S0, torch.zeros(256, dtype=torch.bool, device=dev)
    recs = []
    for _ in range(40):
        S, rec, ex = fused._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
        recs.append(rec)
    keep = ~exempt
    assert int(exempt.sum()) <= 2
    for k in fused.STATE_FIELDS:
        assert _equal(Sk[k], S[k], keep), k
    for k in ("feats", "action", "reward", "done"):
        assert _equal(tk[k], torch.stack([r[k] for r in recs]), keep), k
    for k in ("logp", "value"):
        torch.testing.assert_close(
            tk[k][..., keep], torch.stack([r[k] for r in recs])[..., keep],
            rtol=0, atol=1e-5,
        )
    boot = fused._bootstrap_value(S, statics)
    torch.testing.assert_close(bk[:, keep], boot[:, keep], rtol=0, atol=1e-5)


def test_savanna_kernels_reject_bad_inputs(dev):
    fused, S = _savanna({}, {}, "init", dev, B=64)
    before = fused_savanna_rollout.launches
    with pytest.raises(ValueError):
        fused.rollout({**S, "predator": S["predator"].double()}, 1)
    with pytest.raises(ValueError):
        fused.rollout({**S, "visits": S["visits"].t().contiguous().t()}, 1)
    with pytest.raises(ValueError):
        fused.rollout(S, 1, tile=48)
    other = fused.init_packed(0, 32, dev)  # layouts drawn for 32 lanes
    with pytest.raises(ValueError):
        fused.rollout(S, 1)
    assert fused_savanna_rollout.launches == before
    with pytest.raises(ValueError):
        fused.rollout_collect(other, _params(fused, dev, hidden=20000), 2)
    assert torch.equal(fused.rollout(other, 0)["pos"], other["pos"])


def test_savanna_batched_env_and_train_step_on_the_card(dev):
    env = BatchedEnv("aintelope_savanna", batch_size=256, device=dev,
                     max_iterations=10)
    before = fused_savanna_rollout.launches
    stats = env.rollout(23)  # 10 steps and a reset, twice
    assert fused_savanna_rollout.launches == before + 1
    assert env.kernel == "fused_cuda" and stats["episodes"] == 512
    fused = FusedSavanna(AIntelopeSavanna(max_iterations=20))
    config = ppo_fused.FusedPPOConfig(n_steps=16, n_epochs=2, n_minibatches=4,
                                      hidden=32)
    state = ppo_fused.init_train_state(fused, 256, seed=1, config=config,
                                       device="cuda")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = ppo_fused.make_train_step(fused, config, device="cuda")
    before = fused_savanna_collect.launches
    state, metrics = step(state)
    assert fused_savanna_collect.launches == before + 1
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    assert max(float((state.params[k].detach() - p0[k]).abs().max())
               for k in p0) > 0


# ------------------------------------------------------- the generic path


def test_threefry_on_the_card_equals_the_cpu(dev):
    from ai_safety_gridworlds_torch.core import threefry

    rng = np.random.default_rng(0)
    keys = torch.from_numpy(
        rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint64)
        .astype(np.int64)
    )
    data = torch.from_numpy(rng.integers(0, 2**32, size=4096,
                                         dtype=np.uint64).astype(np.int64))
    for fn in (
        lambda k, d: threefry.split(k, 3),
        lambda k, d: threefry.fold_in(k, d),
        lambda k, d: threefry.randint(k, (), 0, 5),
        lambda k, d: threefry.randint(k, (7,), -3, 4),
        lambda k, d: threefry.uniform(k, (2, 17, 17)),
        lambda k, d: threefry.permutation(k, 3),
        lambda k, d: threefry.bernoulli(k, 0.3, (4,)),
    ):
        want = fn(keys, data)
        got = fn(keys.to(dev), data.to(dev)).cpu()
        assert want.dtype == got.dtype and torch.equal(want, got)


@pytest.mark.parametrize("name", ["boat_race", "island_navigation"])
def test_generic_rollout_on_the_card_equals_the_cpu(dev, name):
    from ai_safety_gridworlds_torch.core import base

    env = factory.get_raw_env(name)
    eps_c, st_c = base.rollout(env, 7, 150, 256, device="cpu")
    eps_g, st_g = base.rollout(env, 7, 150, 256, device=dev)
    for f in ("t", "key", "pos"):
        assert torch.equal(getattr(eps_c.env_state, f),
                           getattr(eps_g.env_state, f).cpu()), f
    for k in st_c:
        assert torch.equal(st_c[k], st_g[k].cpu()), k
    stats = BatchedEnv(name, 256, backend="generic", device=dev).rollout(8)
    assert stats["kernel"] == "generic_torch"


def test_generic_firemaker_on_the_card_equals_the_cpu(dev):
    """Exact but for lanes with a spread draw within 1e-6 of its cum
    (``exp`` may round differently on the card), at most 0.1% of lanes."""
    from ai_safety_gridworlds_torch.ma.safety_game_ma import ma_rollout

    out = {}
    for d in ("cpu", dev):
        env = FiremakerExMa(max_iterations=40)
        env.draw_gaps = []
        eps, _ = ma_rollout(env, 3, 48, 256, device=d)
        out[str(d)] = (eps, torch.stack(env.draw_gaps).cpu())
    (ec, gc), (eg, gg) = out["cpu"], out[str(dev)]
    close = ((gc < 1e-6) | (gg < 1e-6)).any(dim=0)
    diff = torch.zeros(256, dtype=torch.bool)
    for f in ("pos", "fire", "visits", "termination_reasons", "key"):
        a, b = getattr(ec.env_state, f), getattr(eg.env_state, f).cpu()
        diff |= (a != b).reshape(256, -1).any(dim=1)
    assert not (diff & ~close).any()
    assert int(diff.sum()) <= 0.001 * 256


@pytest.mark.parametrize("name,kw", [
    ("boat_race_ex", {}),
    ("island_navigation_ex", {}),
    ("island_navigation_ex", dict(
        level=3, sustainability_challenge=True, thirst_hunger_death=True,
        penalise_oversatiation=True, use_satiation_proportional_reward=True)),
], ids=["boat_race_ex", "island_navigation_ex", "island_navigation_ex_full"])
def test_generic_scalar_ex_on_the_card_equals_the_cpu(dev, name, kw):
    """Exact but for island_navigation_ex's fractions (within 1e-5: CUDA's
    powf and the CPU's pow differ in the last bits) and its lanes whose
    regrown power came within 1e-5 of an integer, at most 1% of lanes."""
    from ai_safety_gridworlds_torch.core import base

    out = {}
    for d in ("cpu", dev):
        env = factory.get_raw_env(name, **kw)
        env.regrow_gaps = []
        eps, st = base.rollout(env, 7, 64, 256, device=d)
        gaps = (torch.stack(env.regrow_gaps).cpu() if env.regrow_gaps
                else torch.full((1, 256), float("inf")))
        out[str(d)] = (eps, st, gaps)
    (ec, sc, gc), (eg, sg, gg) = out["cpu"], out[str(dev)]
    close = ((gc <= 1e-5) | (gg <= 1e-5)).any(dim=0)
    diff = torch.zeros(256, dtype=torch.bool)
    for f in vars(ec.env_state):
        a, b = getattr(ec.env_state, f), getattr(eg.env_state, f).cpu()
        tol = 1e-5 if f.endswith("_fraction") else 0.0
        diff |= ((a - b).abs() > tol).reshape(256, -1).any(dim=1)
    for f in ("last_step_type", "episode_return"):
        a, b = getattr(ec, f), getattr(eg, f).cpu()
        diff |= (a != b).reshape(256, -1).any(dim=1)
    assert not (diff & ~close).any()
    assert int(close.sum()) <= 0.01 * 256
    if not close.any():
        for k in sc:
            assert torch.equal(sc[k], sg[k].cpu()), k
    stats = BatchedEnv(name, 256, backend="generic", device=dev,
                       **kw).rollout(8)
    assert stats["kernel"] == "generic_torch"


SAVANNA_FULL_KW = dict(
    level=0, amount_agents=2, amount_predators=3, amount_water_tiles=3,
    amount_gold_deposits=2, amount_silver_deposits=2, amount_drink_holes=2,
    amount_small_food_patches=1, amount_small_drink_holes=1,
    penalise_oversatiation=True, thirst_hunger_death=True,
)


@pytest.mark.parametrize("name,kw", [
    ("island_navigation_ex_ma", {}),
    ("island_navigation_ex_ma", dict(
        level=3, sustainability_challenge=True, thirst_hunger_death=True,
        penalise_oversatiation=True, use_satiation_proportional_reward=True)),
    ("aintelope_savanna", {"max_iterations": 20}),
    ("aintelope_savanna", {"sustainability_challenge": True,
                           "max_iterations": 20}),
    ("aintelope_savanna", dict(SAVANNA_FULL_KW, max_iterations=20)),
], ids=["island_ma", "island_ma_rich", "savanna", "savanna_sustain",
        "savanna_full"])
def test_generic_ma_chains_on_the_card_equal_the_cpu(dev, name, kw):
    """``ma_rollout`` at B = 256 for 32 steps from one key: exact but for
    the regrown floats (fractions and availabilities within 1e-5: CUDA's
    powf and the CPU's pow differ in the last bits), the gold and silver
    dims of the returns (1e-5 relative, 1e-4 absolute per episode: logf)
    and lanes whose regrown power came within 1e-5 of an integer, at most
    1%. Each lane's episode count and summed final returns are compared
    too, on every lane that is not exempt."""
    from ai_safety_gridworlds_torch.ma.safety_game_ma import ma_rollout

    out = {}
    for d in ("cpu", dev):
        env = factory.get_raw_env(name, **kw)
        env.regrow_gaps = []
        eps, st = ma_rollout(env, 7, 32, 256, device=d, lane_stats=True)
        gaps = (torch.stack(env.regrow_gaps).cpu() if env.regrow_gaps
                else torch.full((1, 256), float("inf")))
        out[str(d)] = (eps, st, gaps)
    (ec, sc, gc), (eg, sg, gg) = out["cpu"], out[str(dev)]
    close = ((gc <= 1e-5) | (gg <= 1e-5)).any(dim=0)
    diff = torch.zeros(256, dtype=torch.bool)
    for f in vars(ec.env_state):
        a, b = getattr(ec.env_state, f), getattr(eg.env_state, f).cpu()
        assert a.dtype == b.dtype, f
        tol = 1e-5 if f.endswith(("_fraction", "_avail")) else 0.0
        if a.dtype == torch.bool:
            d = a != b
        else:
            d = (a.to(torch.float64) - b.to(torch.float64)).abs() > tol
        diff |= d.reshape(256, -1).any(dim=1)
    gold = [k for k, n in enumerate(env.reward_space.keys)
            if n in ("GOLD", "SILVER")]
    rc, rg = ec.episode_returns, eg.episode_returns.cpu()
    rdiff = rc != rg
    if gold:
        rdiff[..., gold] = ~torch.isclose(rg[..., gold], rc[..., gold],
                                          rtol=1e-5, atol=1e-4)
    diff |= rdiff.reshape(256, -1).any(dim=1)
    # Each lane's episodes and summed final returns, so that a divergence
    # in an earlier episode shows on its lane; the gold tolerance is per
    # episode summed.
    lane_eps = sc["lane_episodes"]
    diff |= lane_eps != sg["lane_episodes"].cpu()
    lc, lg = sc["lane_final_returns"], sg["lane_final_returns"].cpu()
    ldiff = lc != lg
    if gold:
        atol = 1e-4 * lane_eps.clamp(min=1).to(torch.float32)[:, None, None]
        ldiff[..., gold] = ((lg - lc).abs() > atol + 1e-5 * lc.abs())[..., gold]
    diff |= ldiff.reshape(256, -1).any(dim=1)
    assert not (diff & ~close).any()
    assert int(close.sum()) <= 0.01 * 256
    if not close.any():
        assert torch.equal(sc["episodes"], sg["episodes"].cpu())
        assert torch.allclose(sc["sum_final_returns"],
                              sg["sum_final_returns"].cpu(), rtol=1e-5,
                              atol=1e-3 if gold else 0.0)
    stats = BatchedEnv(name, 256, backend="generic", device=dev,
                       **kw).rollout(8)
    assert stats["kernel"] == "generic_torch"


def test_auto_takes_the_generic_chain_for_static_kernel_limits(dev):
    """On the card ``init_packed`` refuses what K6-K9 lack whatever the
    state (``check_static_limits``): "auto" runs such a configuration on
    the generic chain, "fused" and a direct pack raise. K8 spawns and
    removes tiles on at most 512 cells, so a 25 x 25 map under
    sustainability is one."""
    big = dict(map_width=25, map_height=25, sustainability_challenge=True,
               max_iterations=10)
    env = BatchedEnv("aintelope_savanna", 64, device=dev, **big)
    assert env.kernel == "generic_torch" and env.fused is None
    # One agent: every lane's episode ends at steps 10 and 21.
    assert env.rollout(22)["episodes"] == 2 * 64
    with pytest.raises(NotImplementedError, match="512"):
        BatchedEnv("aintelope_savanna", 64, device=dev, backend="fused",
                   **big)
    island = FusedIslandMa(IslandNavigationExMa(map_randomization_frequency=1))
    with pytest.raises(NotImplementedError, match="layout pool"):
        island.init_packed(0, 8, dev, layout_pool=9)
    # The default configurations keep their kernels.
    assert BatchedEnv("aintelope_savanna", 64, device=dev).kernel == \
        "fused_cuda"
    assert BatchedEnv("island_navigation_ex_ma", 64, device=dev).kernel == \
        "fused_cuda"


@pytest.mark.parametrize("n", [5, 10])
def test_auto_takes_the_savanna_kernel_at_five_to_ten_agents(dev, n):
    """K8 runs 1..10 agents: "auto" keeps it, one launch a rollout."""
    env = BatchedEnv("aintelope_savanna", 64, device=dev, amount_agents=n,
                     max_iterations=10)
    assert env.kernel == "fused_cuda" and env.fused is not None
    before = fused_savanna_rollout.launches
    stats = env.rollout(12)
    assert fused_savanna_rollout.launches == before + 1
    assert stats["episodes"] > 0

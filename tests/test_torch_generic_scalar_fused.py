"""K4's plain version against the generic chain it was ported from, all
15 scalar bodies, in the port alone on the CPU.

The mirror of ``tests/test_fused_scalar.py::test_fused_step_matches_per_env_chain``:
the port's plain ``FusedScalarBase`` step runs B = 6 lanes for 25 steps;
its drawn actions drive the port's generic chain (``env.step``), and its
per-episode draws, read off the packed state after a reset
(``unpack_lane_common`` and the extra rows), start the chain's episodes
through ``initial_state(key, options)``. tomato_watering's drying uniforms
go in as the ``dry_draws`` and ``reset_dry_draws`` options. Every lane's
position, ``t``, step type, returns and extra state, every reward and the
episode accounting are exact, with one exception: island_navigation_ex's
regrowth takes ``exp(e * log(x))`` in the fused step and ``pow`` in the
chain, so its fractions agree within 1e-5 and a lane whose power came
within 1e-5 of an integer (``regrow_gap`` in the fused step's draws, the
chain's ``regrow_gaps``) is exempt from that step on.
"""

import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.core.base import tree_where
from ai_safety_gridworlds_torch.helpers import factory
from torch_threads import one_torch_thread  # noqa: F401

B, K = 6, 25
FIRST = 0
GAP = FRAC_TOL = 1e-5
FULL = {"level": 3, "sustainability_challenge": True,
        "thirst_hunger_death": True, "penalise_oversatiation": True,
        "use_satiation_proportional_reward": True}

# tests/test_fused_scalar.py's cases: every body, its variants and flags.
CASES = [
    ("boat_race", {}),
    ("boat_race", {"max_iterations": 7}),
    ("island_navigation", {"max_iterations": 9}),
    ("boat_race_ex", {}),
    ("boat_race_ex", {"max_iterations": 11}),
    ("boat_race_ex", {"level": 3, "noops": False}),
    ("island_navigation_ex", {}),
    ("island_navigation_ex", {"max_iterations": 13}),
    ("island_navigation_ex", FULL),
    ("island_navigation_ex", {"level": 4, "sustainability_challenge": False}),
    ("side_effects_sokoban", {}),
    ("side_effects_sokoban", {"level": 1, "noops": True}),
    ("side_effects_sokoban", {"level": 3}),
    ("absent_supervisor", {}),
    ("absent_supervisor", {"supervisor": True}),
    ("distributional_shift", {"is_testing": True}),
    ("safe_interruptibility", {}),
    ("safe_interruptibility", {"level": 0, "interruption_probability": 1.0}),
    ("safe_interruptibility_ex", {"level": 2, "interruption_probability": 1.0}),
    ("whisky_gold", {}),
    ("tomato_watering", {}),
    ("tomato_crmdp", {}),
    ("conveyor_belt", {"variant": "vase"}),
    ("conveyor_belt", {"variant": "sushi"}),
    ("conveyor_belt", {"variant": "sushi_goal", "noops": True}),
    ("conveyor_belt", {"variant": "sushi_goal2"}),
    ("rocks_diamonds", {}),
    ("rocks_diamonds", {"level": 1}),
    ("friend_foe", {}),
    ("friend_foe", {"bandit_type": "friend"}),
    ("friend_foe", {"bandit_type": "adversary", "extra_step": True}),
    ("conveyor_belt_ex", {"variant": "vase"}),
    ("conveyor_belt_ex", {"variant": "sushi_goal", "noops": True}),
]

# Packed extra rows -> the chain state's field.
FIELDS = {
    "safety": "safety", "sup": "supervisor", "level": "level",
    "should": "should_interrupt", "pressed": "pressed", "drunk": "drunk",
    "exploring": "exploring", "obj": "obj_pos", "obj_end": "obj_end",
    "perf_adj": "perf_adjusted", "rock_high": "rock_switch_high",
    "dia_high": "diamond_switch_high", "bandit": "bandit_type",
    "showing": "showing_goals", "policies": "policies",
    "drink_sat": "drink_satiation", "food_sat": "food_satiation",
    "drink_avail": "drink_availability", "food_avail": "food_availability",
    "drink_frac": "drink_fraction", "food_frac": "food_fraction",
    "boxes": "boxes", "prev_pen": "prev_penalty", "coins": "coins",
    "watered": "watered", "lumps": "lumps",
}
APPROX = ("drink_frac", "food_frac")


def _ids(cases):
    return [n + "".join(f"-{k}{v}" for k, v in kw.items())
            for n, kw in cases]


def _reset_options(name, S, draws):
    """The chain's ``initial_state`` options that reproduce the packed
    state's freshly reset lanes: the per-episode draws the kernel made."""
    if name == "absent_supervisor":
        return {"supervisor": S["sup"][0] > 0.5}
    if name == "distributional_shift":
        return {"level": S["level"][0]}
    if name.startswith("safe_interruptibility"):
        return {"should_interrupt": S["should"][0] > 0.5}
    if name == "friend_foe":
        return {"bandit_type": S["bandit"][0], "level": S["level"][0],
                "policies": S["policies"].T.reshape(B, 3, 2)}
    if name.startswith("tomato"):
        if draws is None:  # the first episode: its sweep was drawn on host
            return {"reset_dry_draws": torch.full((B, S["watered"].shape[0]),
                                                  2.0)}
        return {"reset_dry_draws": draws["u_reset"].T}
    return None


def _packed(fused, S, field, state):
    """The chain state's field in the packed layout ``[rows, B]``, in the
    packed field's dtype."""
    if field == "visits":  # boat_race_ex's visit board, or island's counts
        v = getattr(state, "visit_count", getattr(state, "visits", None))
    else:
        v = getattr(state, FIELDS[field])
    if field in ("boxes", "lumps", "obj"):
        v = v[..., 0] * fused.w + v[..., 1]
    return v.reshape(B, -1).T.to(S[field].dtype)


def _start(name, env, fused, S):
    keys = torch.zeros((B, 2), dtype=torch.int64)
    state = env.initial_state(keys, _reset_options(name, S, None))
    if name.startswith("tomato"):
        state = state.replace(watered=S["watered"].T > 0.5)
    return keys, state


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_fused_plain_step_matches_the_generic_chain(name, kw):
    env = factory.get_raw_env(name, **kw)
    fused = tops.make_fused(env)
    S = fused.init_packed(11, B, "cpu")
    keys, state = _start(name, env, fused, S)
    if name == "island_navigation_ex":
        env.regrow_gaps = []
    D = S["ep_ret"].shape[0]
    ep_ret = torch.zeros((B, D))
    hid_ret = torch.zeros(B)
    last = torch.full((B,), FIRST, dtype=torch.int32)
    episodes, stats_ret = torch.zeros(B, dtype=torch.int32), torch.zeros(B, D)
    exempt = torch.zeros(B, dtype=torch.bool)
    resets = 0
    for step in range(K):
        S2, draws = fused.step(S, collect_draws=True)
        actions = draws["actions"][0]
        over = actions < 0
        resets += int(over.sum())
        assert torch.equal(over, last == 2), step
        a = torch.where(over, env.action_min, actions).to(torch.int32)
        options = None
        if name.startswith("tomato"):
            options = {"dry_draws": draws["u_phys"].T}
        stepped, out = env.step(state, a, options)
        fresh = env.initial_state(keys, _reset_options(name, S2, draws))
        state = tree_where(over, fresh, stepped)
        if "regrow_gap" in draws:
            exempt |= draws["regrow_gap"][0] <= GAP
        if getattr(env, "regrow_gaps", None):
            exempt |= (env.regrow_gaps.pop() <= GAP) & ~over
        keep = ~exempt
        reward = out.reward.reshape(B, D)
        assert torch.equal(
            torch.where(over[:, None], 0.0, reward)[keep],
            draws["rewards"].T[keep]), f"step {step} rewards"
        ep_ret = torch.where(over[:, None], 0.0, ep_ret + reward)
        hid_ret = torch.where(over, 0.0, hid_ret + out.hidden_reward)
        last = torch.where(over, FIRST, out.step_type)
        done = out.game_over & ~over
        episodes += done.to(torch.int32)
        stats_ret += torch.where(done[:, None], ep_ret, 0.0)
        flat = state.pos[:, 0] * fused.w + state.pos[:, 1]
        for got, want, f in (
            (flat, S2["pos"][0], "pos"), (state.t, S2["t"][0], "t"),
            (last, S2["step_types"][0], "step_types"),
            (ep_ret.T, S2["ep_ret"], "ep_ret"),
            (hid_ret, S2["hid_ret"][0], "hid_ret"),
            (episodes, S2["stats_episodes"][0], "stats_episodes"),
            (stats_ret.T, S2["stats_return"], "stats_return"),
        ):
            assert torch.equal(got[..., keep], want[..., keep]), (
                f"step {step} {f}")
        for f in fused.EXTRA_FIELDS:
            got = _packed(fused, S2, f, state)[:, keep]
            want = S2[f][:, keep]
            if f in APPROX:
                assert torch.allclose(got, want, rtol=0, atol=FRAC_TOL), (
                    f"step {step} {f}")
            else:
                assert torch.equal(got, want), f"step {step} {f}"
        S = S2
    assert resets > 0 or fused.max_iterations > K
    assert int(exempt.sum()) <= 1

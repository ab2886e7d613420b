"""The port's scalar PPO collection, linear policies and learning gate
against the JAX package's.

Tolerances, as in ``tests/test_torch_collect.py``:

* Integer state, actions, rewards, dones and features are equal, except on
  a lane where some step's site-0 uniform lies within 1e-6 of a cumulative
  softmax sum (``cdf_gap``): there the float32 rounding of the two MLPs may
  flip the draw, and the lane's episode then diverges.
* ``logp``, ``value`` and ``boot`` agree within 1e-5: JAX leaves the MLP to
  its matrix products, the port accumulates in the kernel's fixed order.

The linear policy is exact: the logits are one elementwise chain in both
packages, compared against JAX's eager step.

island_navigation_ex's regrowth fractions agree within 1e-5, and a lane
whose regrown power came within 1e-5 of an integer (``regrow_gap``) is
exempt with the CDF-margin lanes (``tests/test_torch_fused_island_nav_ex.py``
states why); absent_supervisor's per-episode draw is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.envs import absent_supervisor as tas
from ai_safety_gridworlds_torch.envs import boat_race as tbr
from ai_safety_gridworlds_torch.envs import boat_race_ex as tbrx
from ai_safety_gridworlds_torch.envs import island_navigation as tisl
from ai_safety_gridworlds_torch.envs import island_navigation_ex as tinx
from ai_safety_gridworlds_torch.learners import ppo_fused as tppo
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.envs import absent_supervisor as jas
from ai_safety_gridworlds_tpu.envs import boat_race as jbr
from ai_safety_gridworlds_tpu.envs import boat_race_ex as jbrx
from ai_safety_gridworlds_tpu.envs import island_navigation as jisl
from ai_safety_gridworlds_tpu.envs import island_navigation_ex as jinx
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops import fused_scalar as J

GAP = 1e-6
REGROW_GAP = 1e-5
FRAC_TOL = 1e-5
FRACS = ("drink_frac", "food_frac")
INTS = ("feats", "action", "reward", "done")


def _short(env, max_iterations):
    """``env`` with shorter episodes (absent_supervisor fixes 100)."""
    env.max_iterations = max_iterations
    return env


COLLECT = {
    "boat_race": (lambda: T.FusedBoatRace(tbr.BoatRace(max_iterations=12)),
                  lambda: J.FusedBoatRace(jbr.BoatRace(max_iterations=12))),
    "boat_race_ex": (
        lambda: T.FusedBoatRaceEx(tbrx.BoatRaceEx(max_iterations=15)),
        lambda: J.FusedBoatRaceEx(jbrx.BoatRaceEx(max_iterations=15)),
    ),
    "island_navigation_ex": (
        lambda: T.FusedIslandNavEx(tinx.IslandNavigationEx(max_iterations=15)),
        lambda: J.FusedIslandNavEx(jinx.IslandNavigationEx(max_iterations=15)),
    ),
    "absent_supervisor": (
        lambda: T.FusedAbsentSupervisor(_short(tas.AbsentSupervisor(), 12)),
        lambda: J.FusedAbsentSupervisor(_short(jas.AbsentSupervisor(), 12)),
    ),
}


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("name", sorted(COLLECT))
def test_rollout_collect_matches_jax_xla(name, start):
    tf, jf = (make() for make in COLLECT[name])
    B, T_ = 96, 24
    p_j = jppo.init_params(
        jax.random.PRNGKey(1), jf.POLICY_FEATURES, jf.amax - jf.amin + 1,
        hidden=16,
    )
    # Larger policy weights than init's near-uniform ones, so that the
    # draws depend on the features.
    p_j = {**p_j, "mlp_w2": p_j["mlp_w2"] * 30.0}
    p_t = interop.params_from_numpy({k: np.asarray(v) for k, v in p_j.items()},
                                    "cpu")
    if start == "init":
        tS0 = tf.init_packed(4, B, "cpu")
    else:
        tS0 = interop.busy_scalar_state(tf, 4, B, "cpu")
    S_np = interop.state_to_numpy(tS0)
    jf.init_packed(seed=4, batch=B)
    jS, jtraj, jboot = jf.rollout_collect(
        {k: jnp.asarray(v) for k, v in S_np.items()}, p_j, T_, backend="xla"
    )
    tS, traj, boot = tf.rollout_collect(tS0, p_t, T_)
    # The lanes whose draw lies near a CDF boundary at some step, from the
    # plain step loop (rollout_collect_plain runs the same loop).
    statics = tf._collect_statics(tS0, p_t)
    S, exempt = tS0, torch.zeros(B, dtype=torch.bool)
    for _ in range(T_):
        S, _, ex = tf._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < GAP).any(dim=0)
        if "regrow_gap" in ex:
            exempt |= (ex["regrow_gap"] <= REGROW_GAP).any(dim=0)
    for k in tf.STATE_FIELDS:
        assert torch.equal(S[k], tS[k]), k
    keep = ~exempt.numpy()
    assert exempt.sum() <= 2
    for nm, rows, dtype in tf._traj_layout():
        assert traj[nm].shape == (T_, rows, B) and traj[nm].dtype == dtype
        got, want = traj[nm].numpy()[..., keep], np.asarray(jtraj[nm])[..., keep]
        if nm in INTS:
            np.testing.assert_array_equal(got, want, err_msg=nm)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=nm)
    for k in jf.STATE_FIELDS:
        got, want = tS[k].numpy()[:, keep], np.asarray(jS[k])[:, keep]
        if k in FRACS:
            np.testing.assert_allclose(got, want, rtol=0, atol=FRAC_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(boot.numpy()[:, keep], np.asarray(jboot)[:, keep],
                               rtol=0, atol=1e-5)
    acts = traj["action"].numpy()
    assert (acts == -1).any() and (acts >= tf.amin).any()
    assert traj["done"].numpy().any()


def test_collection_sums_the_reward_dims():
    """boat_race_ex (D = 5): each record's reward is its step's [D, B]
    reward vector summed over D."""
    tf = COLLECT["boat_race_ex"][0]()
    assert tf.D == 5
    p = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jppo.init_params(
            jax.random.PRNGKey(0), 2, tf.amax - tf.amin + 1, hidden=8
        ).items()}, "cpu",
    )
    S = interop.busy_scalar_state(tf, 6, 32, "cpu")
    statics = tf._collect_statics(S, p)
    for _ in range(8):
        S, rec, ex = tf._collect_step(S, statics)
        assert ex["rewards"].shape == (5, 32)
        torch.testing.assert_close(rec["reward"], ex["rewards"].sum(0, keepdim=True),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
def test_linear_policy_matches_jax_eager_on_island(shared):
    kw = {"max_iterations": 12}
    tf = T.FusedIslandNav(tisl.IslandNavigation(**kw))
    jf = J.FusedIslandNav(jisl.IslandNavigation(**kw))
    B = 64
    rng = np.random.default_rng(3)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    lanes = () if shared else (B,)
    W = rng.normal(size=lanes + (A, F)).astype(np.float32)
    b = rng.normal(size=lanes + (A,)).astype(np.float32)
    eps = np.float32(0.1) if shared else rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS = interop.busy_scalar_state(tf, 8, B, "cpu")
    jf.init_packed(seed=0, batch=B)
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    for step in range(25):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(td["actions"].numpy(),
                                      np.asarray(jd["actions"]),
                                      err_msg=f"step {step}")
        for k in jf.STATE_FIELDS:
            np.testing.assert_array_equal(tS[k].numpy(), np.asarray(jS[k]),
                                          err_msg=f"step {step} {k}")
    # The policy changed what happened: the uniform rollout differs.
    tf.set_policies(None, None)
    tU = tf.rollout(interop.busy_scalar_state(tf, 8, B, "cpu"), 25)
    assert not torch.equal(tU["pos"], tS["pos"])


@pytest.mark.parametrize("name", ["island_navigation_ex", "absent_supervisor"])
def test_linear_policy_matches_jax_eager_on_new_bodies(name):
    """Per-lane linear policies on island_navigation_ex (F = 6, D = 10) and
    absent_supervisor (F = 3, per-episode draws), 25 steps from a busy state
    against JAX's eager step; regrowth lanes as in the collection test."""
    tf, jf = (make() for make in COLLECT[name])
    B = 64
    rng = np.random.default_rng(4)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    W = rng.normal(size=(B, A, F)).astype(np.float32)
    b = rng.normal(size=(B, A)).astype(np.float32)
    eps = rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS = interop.busy_scalar_state(tf, 8, B, "cpu")
    jf.init_packed(seed=0, batch=B)
    jS = {k: jnp.asarray(v) for k, v in interop.state_to_numpy(tS).items()}
    exempt = np.zeros(B, bool)
    for step in range(25):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        keep = ~exempt
        np.testing.assert_array_equal(td["actions"].numpy()[:, keep],
                                      np.asarray(jd["actions"])[:, keep],
                                      err_msg=f"step {step}")
        if "regrow_gap" in td:
            exempt |= td["regrow_gap"].numpy()[0] <= REGROW_GAP
        keep = ~exempt
        for k in jf.STATE_FIELDS:
            got, want = tS[k].numpy()[:, keep], np.asarray(jS[k])[:, keep]
            if k in FRACS:
                np.testing.assert_allclose(got, want, rtol=0, atol=FRAC_TOL)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"step {step} {k}")
    assert exempt.sum() <= 2
    tf.set_policies(None, None)


@pytest.mark.parametrize("name", ["island_navigation_ex", "absent_supervisor"])
def test_train_step_composes_on_new_bodies(name):
    """One fused-PPO update through the plain collection, as JAX's
    test_fused_ppo_collection_composes_on_every_kernel does: finite
    metrics, moved params, the state advanced."""
    tf = COLLECT[name][0]()
    config = tppo.FusedPPOConfig(n_steps=8, n_epochs=1, n_minibatches=2,
                                 hidden=16)
    state = tppo.init_train_state(tf, 32, seed=2, config=config, device="cpu")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    train = tppo.make_train_step(tf, config, device="cpu")
    state2, metrics = train(state)
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    assert max(float((state2.params[k].detach() - p0[k]).abs().max())
               for k in p0) > 0
    assert int(state2.S["draw_ctr"][0, 0]) == 8


def test_fused_ppo_learns_island_navigation():
    """Mirrors tests/test_ppo_learning.py::
    test_fused_ppo_learns_island_navigation_scalar_kernel with the port's
    learner and the plain collection: 40 CPU-sized updates must lift the
    mean evaluated episode return by more than 15 to above 10, with more
    than 50 episodes evaluated before and after. ``chip_smoke.py`` runs the
    same gate through the collection kernel K5 on the card."""
    fused = T.FusedIslandNav(tisl.IslandNavigation())
    config = tppo.FusedPPOConfig(
        n_steps=32, n_epochs=2, n_minibatches=2, hidden=32, lr=1e-3
    )
    state = tppo.init_train_state(fused, 64, seed=3, config=config,
                                  device="cpu")
    train = tppo.make_train_step(fused, config, device="cpu")
    ev0 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    for _ in range(40):
        state, metrics = train(state)
    assert torch.isfinite(metrics["mean_reward"])
    ev1 = tppo.evaluate(fused, state.params, n_steps=128, batch=64, seed=9,
                        device="cpu")
    r0, r1 = ev0["mean_episode_return"], ev1["mean_episode_return"]
    print(f"island_navigation gate on the CPU: r0 {r0}, r1 {r1}")
    assert ev0["episodes"] > 50 and ev1["episodes"] > 50
    assert r1 - r0 > 15.0, (r0, r1)
    assert r1 > 10.0, r1

"""The port's scalar bodies with more draws (whisky_gold; tomato_watering
and tomato_crmdp, whose drying draws 13 uniforms a step at PRF site 2 and
whose reset sweep 13 at site 1; friend_foe, whose reset draws the bandit and
the neutral level in two rows and whose policy estimates carry across
episodes) against the JAX package's ``ops/fused_scalar.py``.

The same seeds, or one numpy state, go to both packages, and the first
episode's draws are made on the host with numpy as JAX's ``init_packed``
makes them. Tolerances:

* Against JAX's eager ``step_xla``: 0 for every field, dtype, action, reward
  and reset or physics uniform.
* Against JAX's jitted ``rollout(..., backend="xla")``: 0 for every field
  but two. XLA rewrites tomato_watering's ``sum(watered) * 0.02`` inside its
  fused loop, so ``hid_ret`` and ``stats_hidden`` there agree within 1e-5
  relative (their eager values are the port's, bit for bit); and it rewrites
  friend_foe's ``n / (n0 + n1)``, so ``policies`` agree within 4 ulp. The
  observed rewards, returns and every other field stay exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch import ops as tops
from ai_safety_gridworlds_torch.envs import friend_foe as tff
from ai_safety_gridworlds_torch.envs import tomato_watering as ttw
from ai_safety_gridworlds_torch.envs import whisky_gold as twg
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.ops import fused_scalar as T
from ai_safety_gridworlds_torch.ops import interop
from ai_safety_gridworlds_tpu.envs import friend_foe as jff
from ai_safety_gridworlds_tpu.envs import tomato_watering as jtw
from ai_safety_gridworlds_tpu.envs import whisky_gold as jwg
from ai_safety_gridworlds_tpu.learners import ppo_fused as jppo
from ai_safety_gridworlds_tpu.ops import fused_scalar as J

CASES = [
    ("whisky_gold", {}),
    ("tomato_watering", {}),
    ("tomato_crmdp", {}),
    ("friend_foe", {}),
    ("friend_foe", {"bandit_type": "friend"}),
    ("friend_foe", {"bandit_type": "adversary", "extra_step": True}),
]
PAIRS = {
    "whisky_gold": (twg.WhiskyGold, T.FusedWhiskyGold, jwg.WhiskyGold,
                    J.FusedWhiskyGold),
    "tomato_watering": (ttw.TomatoWatering, T.FusedTomatoWatering,
                        jtw.TomatoWatering, J.FusedTomatoWatering),
    "tomato_crmdp": (ttw.TomatoCRMDP, T.FusedTomatoWatering, jtw.TomatoCRMDP,
                     J.FusedTomatoWatering),
    "friend_foe": (tff.FriendFoe, T.FusedFriendFoe, jff.FriendFoe,
                   J.FusedFriendFoe),
}
ENV_STATICS = ("_wall_mask", "_goal_mask", "_start_pos", "_whisky_pos",
               "_transformer_mask", "_tomato_pos", "_initially_watered",
               "_delusional_mask", "_goal_pos", "_nogoal_pos")
ENV_FLAGS = ("action_min", "action_max", "max_iterations", "name",
             "whisky_exploration", "human_player", "crmdp", "max_reward",
             "bandit_type", "extra_step")
# Fields XLA's jitted rollout rounds otherwise, and their tolerance check.
INEXACT = {
    "hid_ret": lambda got, want: np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6),
    "stats_hidden": lambda got, want: np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6),
    "policies": lambda got, want: np.testing.assert_array_less(
        np.abs(got - want), 4 * np.spacing(np.abs(want)) + 1e-30),
}
INEXACT_FIELDS = {"tomato_watering": ("hid_ret", "stats_hidden"),
                  "tomato_crmdp": ("hid_ret", "stats_hidden"),
                  "friend_foe": ("policies",)}


def _ids(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _pair(name, kw, max_iterations=None):
    tenv_cls, tfused_cls, jenv_cls, jfused_cls = PAIRS[name]
    tenv, jenv = tenv_cls(**kw), jenv_cls(**kw)
    if max_iterations is not None:  # shorter episodes: more reset draws
        tenv.max_iterations = jenv.max_iterations = max_iterations
    return tfused_cls(tenv), jfused_cls(jenv)


def _assert_states_equal(tS, jS, fields, msg="", inexact=()):
    for k in fields:
        got, want = tS[k].numpy(), np.asarray(jS[k])
        assert got.dtype == want.dtype, f"{msg} field {k}: {got.dtype}"
        if k in inexact:
            INEXACT[k](got, want)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} field {k}")


def _start(tf, jf, start, B, seed=7):
    """(port state, JAX state) from init_packed or a busy state."""
    if start == "init":
        return tf.init_packed(seed, B, "cpu"), jf.init_packed(seed=seed,
                                                              batch=B)
    tS = interop.busy_scalar_state(tf, seed, B, "cpu")
    jf.init_packed(seed=seed, batch=B)
    return tS, {k: jnp.asarray(v)
                for k, v in interop.state_to_numpy(tS).items()}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_statics_init_and_routing_equal_jax(case):
    name, kw = case
    tf, jf = _pair(name, kw)
    tenv, jenv = tf.env, jf.env
    for k in ENV_STATICS:
        if hasattr(jenv, k):
            np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k),
                                          err_msg=k)
    for k in ENV_FLAGS:
        if hasattr(jenv, k):
            assert getattr(tenv, k) == getattr(jenv, k), k
    assert (tf.RESET_SITES, tf.RESET_ROWS, tf.n_sites, tf.PHYS_ROWS) == (
        jf.RESET_SITES, jf.RESET_ROWS, jf.n_sites, jf.PHYS_ROWS)
    assert (tf.D, tf.POLICY_FEATURES) == (jf.D, jf.POLICY_FEATURES)
    np.testing.assert_array_equal(tf.DELTAS, jf.DELTAS)
    for seed, B in ((3, 16), (11, 300)):
        tS = tf.init_packed(seed, B, "cpu")
        jS = jf.init_packed(seed=seed, batch=B)
        assert tuple(tf.STATE_FIELDS) == tuple(jf.STATE_FIELDS)
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, "init_packed")
        for k in tf.STATE_FIELDS:
            rows, dtype = tf.field_spec(k)
            assert tS[k].dtype == dtype and tS[k].shape == (rows, B), k
    for attr in ("whisky_flat", "nt", "fixed_bandit", "extra_step",
                 "goal_flat", "nogoal_flat"):
        if hasattr(jf, attr):
            assert getattr(tf, attr) == getattr(jf, attr), attr
    assert set(tf._kstatics_np) == set(jf._kstatics_np)
    interop.assert_consts_equal(tf._kstatics_np, jf._kstatics_np)
    interop.assert_consts_equal(tf.consts, jf.consts)
    assert type(tops.make_fused(factory.get_raw_env(name, **kw))) is type(tf)
    T._check_supported(tf)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_matches_jax_step_xla(case, start):
    """Free steps at max_iterations=6 (25 from init, 20 from a busy state),
    so that every lane redraws its episode several times: the reset and
    physics uniforms, actions, rewards and every state field equal JAX's
    eager step."""
    name, kw = case
    tf, jf = _pair(name, kw, max_iterations=6)
    B = 64
    tS, jS = _start(tf, jf, start, B, seed=5)
    redrawn = 0
    for step in range(25 if start == "init" else 20):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        for k in ("actions", "over", "rewards", "u_reset", "u_phys"):
            if jd[k] is None:
                assert td[k] is None, k
            else:
                np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                              err_msg=f"step {step} {k}")
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
        redrawn += int(td["over"].sum())
    assert redrawn >= B
    if tf.RESET_SITES:
        assert td["u_reset"].shape == (tf.RESET_ROWS, B)
    if tf.PHYS_ROWS:
        assert td["u_phys"].shape == (tf.PHYS_ROWS, B)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rollout_matches_jax_xla(case, start):
    """25 free steps from init_packed, 20 from a busy state (tomato's
    counters across the wrap of 3 * draw_ctr + 2): every field equal to
    JAX's jitted XLA rollout, but for the two rewrites the module states."""
    name, kw = case
    tf, jf = _pair(name, kw, max_iterations=6)
    B = 128
    n = 25 if start == "init" else 20
    tS0, jS0 = _start(tf, jf, start, B)
    tS = tf.rollout(tS0, n)
    jS = jf.rollout(jS0, n, backend="xla")
    _assert_states_equal(tS, jS, jf.STATE_FIELDS,
                         inexact=INEXACT_FIELDS.get(name, ()))
    assert int(tS["stats_episodes"].sum()) >= 2 * B
    if start == "busy":
        ctr0 = interop.state_to_numpy(tS0)["draw_ctr"].astype(np.int64)
        assert int(tS["draw_ctr"].to(torch.int64).min()) < n  # wrapped
        if tf.n_sites == 3:
            # 3 * draw_ctr + 2 crosses 2^32 in some lanes mid-rollout.
            site = 3 * ctr0 + 2
            assert ((site < 2**32) & (site + 3 * n >= 2**32)
                    & (ctr0 < 2**31)).any()


@pytest.mark.parametrize("name,kw", [
    ("whisky_gold", {}), ("tomato_watering", {}), ("friend_foe", {}),
], ids=["whisky_gold", "tomato_watering", "friend_foe"])
def test_linear_policy_matches_jax_eager(name, kw):
    """Per-lane linear policies (F = 3, 15 and 5), 20 steps from a busy
    state against JAX's eager step: actions and every field equal."""
    tf, jf = _pair(name, kw, max_iterations=9)
    B = 64
    rng = np.random.default_rng(4)
    A, F = tf.amax - tf.amin + 1, tf.POLICY_FEATURES
    W = rng.normal(size=(B, A, F)).astype(np.float32)
    b = rng.normal(size=(B, A)).astype(np.float32)
    eps = rng.uniform(0, 0.3, B).astype(np.float32)
    tf.set_policies(W, b, eps)
    jf.set_policies(W, b, eps)
    tS, jS = _start(tf, jf, "busy", B, seed=8)
    for step in range(20):
        tS, td = tf.step(tS, collect_draws=True)
        jS, jd = jf.step_xla(jS, collect_draws=True)
        np.testing.assert_array_equal(td["actions"].numpy(),
                                      np.asarray(jd["actions"]),
                                      err_msg=f"step {step}")
        _assert_states_equal(tS, jS, jf.STATE_FIELDS, f"step {step}")
    tf.set_policies(None, None)


@pytest.mark.parametrize("start", ["init", "busy"])
@pytest.mark.parametrize("name", ["tomato_watering", "friend_foe"])
def test_rollout_collect_matches_jax_xla(name, start):
    """The PPO collection against JAX's: integer state and records equal
    except on lanes whose draw lies within 1e-6 of a CDF boundary,
    logp/value/boot within 1e-5, the module's two rewrites within their
    bounds."""
    tf, jf = _pair(name, {}, max_iterations=12)
    B, T_ = 96, 24
    p_j = jppo.init_params(jax.random.PRNGKey(1), jf.POLICY_FEATURES,
                           jf.amax - jf.amin + 1, hidden=16)
    p_j = {**p_j, "mlp_w2": p_j["mlp_w2"] * 30.0}
    p_t = interop.params_from_numpy({k: np.asarray(v) for k, v in p_j.items()},
                                    "cpu")
    tS0, jS0 = _start(tf, jf, start, B, seed=4)
    jS, jtraj, jboot = jf.rollout_collect(jS0, p_j, T_, backend="xla")
    tS, traj, boot = tf.rollout_collect(tS0, p_t, T_)
    statics = tf._collect_statics(tS0, p_t)
    S, exempt = tS0, torch.zeros(B, dtype=torch.bool)
    for _ in range(T_):
        S, _, ex = tf._collect_step(S, statics)
        exempt |= (ex["pol"]["cdf_gap"] < 1e-6).any(dim=0)
    keep = ~exempt.numpy()
    assert exempt.sum() <= 2
    for nm, rows, dtype in tf._traj_layout():
        assert traj[nm].shape == (T_, rows, B) and traj[nm].dtype == dtype
        got, want = traj[nm].numpy()[..., keep], np.asarray(jtraj[nm])[..., keep]
        if nm in ("feats", "action", "reward", "done"):
            np.testing.assert_array_equal(got, want, err_msg=nm)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=nm)
    inexact = INEXACT_FIELDS.get(name, ())
    for k in jf.STATE_FIELDS:
        got, want = tS[k].numpy()[:, keep], np.asarray(jS[k])[:, keep]
        if k in inexact:
            INEXACT[k](got, want)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(boot.numpy()[:, keep],
                               np.asarray(jboot)[:, keep], rtol=0, atol=1e-5)
    assert traj["done"].numpy().any()


def test_friend_foe_reset_draws_and_carried_policies():
    """Over many short episodes: drawn bandits take all three types, about
    a third each; a friend's level is the argmax and an adversary's the
    argmin of the policy row carried at its reset (first on ties), and the
    rows keep summing to 1."""
    env = tff.FriendFoe()
    env.max_iterations = 5
    tf = T.FusedFriendFoe(env)
    B = 256
    S = tf.init_packed(1, B, "cpu")
    bandits = []
    for _ in range(60):
        pol_before = S["policies"].clone()
        S, d = tf.step(S, collect_draws=True)
        over = d["over"][0]
        bt, lvl = S["bandit"][0, over], S["level"][0, over]
        bandits.append(bt)
        p = pol_before[:, over].view(3, 2, -1)
        rows = p[bt.long(), :, torch.arange(bt.numel())]  # [n, 2]
        argmax = (rows[:, 1] > rows[:, 0]).to(torch.int32)
        argmin = (rows[:, 1] < rows[:, 0]).to(torch.int32)
        assert torch.equal(lvl[bt == 0], argmax[bt == 0])
        assert torch.equal(lvl[bt == 2], argmin[bt == 2])
        torch.testing.assert_close(S["policies"].view(3, 2, B).sum(1),
                                   torch.ones(3, B), rtol=0, atol=1e-6)
    bandits = torch.cat(bandits)
    share = torch.bincount(bandits, minlength=3).float() / bandits.numel()
    assert bool((share > 0.28).all()), share
    assert not torch.equal(S["policies"], torch.full_like(S["policies"], 0.5))


def test_tomato_reset_sweep_and_drying():
    """The reset sweep keeps a tomato watered at the start with probability
    0.95 and never waters a dry one; a step waters the tomato under the
    agent unless it dries that same step, and the hidden reward is 0.02 per
    watered tomato."""
    env = ttw.TomatoWatering()
    env.max_iterations = 3
    tf = T.FusedTomatoWatering(env)
    B = 512
    iw = torch.from_numpy(tf._kstatics_np["iw"]) > 0.5
    S = tf.init_packed(2, B, "cpu")
    kept = []
    for _ in range(12):
        S, d = tf.step(S, collect_draws=True)
        over = d["over"][0]
        w = S["watered"][:, over] > 0.5
        assert not bool(w[~iw[:, 0]].any())
        kept.append(w[iw[:, 0]].float().flatten())
        acting = d["actions"][0] >= 0
        torch.testing.assert_close(
            S["hid_ret"][0, acting & (S["t"][0] == 1)],
            S["watered"][:, acting & (S["t"][0] == 1)].sum(0) * 0.02,
            rtol=0, atol=0)
    share = float(torch.cat(kept).mean())
    assert 0.92 < share < 0.98, share


def test_whisky_gold_limits():
    """The exploration-rate hijack acts for human players only: the fused
    kernel refuses ``human_player=True``, as the JAX class does, and
    ``make_fused`` then gives None (the generic path), as JAX's does."""
    with pytest.raises(NotImplementedError, match="human_player"):
        T.FusedWhiskyGold(twg.WhiskyGold(human_player=True))
    assert tops.make_fused(
        factory.get_raw_env("whisky_gold", human_player=True)
    ) is None
    with pytest.raises(NotImplementedError):
        J.FusedWhiskyGold(jwg.WhiskyGold(human_player=True))


def test_draw_row_limits():
    """K4/K5 take tomato's 13 reset and physics rows and refuse more than
    16 of either, and a draw-site count other than 1 + RESET_SITES +
    (PHYS_ROWS > 0)."""
    tf = T.FusedTomatoWatering(ttw.TomatoWatering())
    T._check_supported(tf)
    tf.PHYS_ROWS = 17
    with pytest.raises(NotImplementedError, match="PHYS_ROWS"):
        T._check_supported(tf)
    tf.PHYS_ROWS, tf.RESET_ROWS = 13, 17
    with pytest.raises(NotImplementedError, match="RESET_ROWS"):
        T._check_supported(tf)
    tf.RESET_ROWS, tf.n_sites = 13, 2
    with pytest.raises(NotImplementedError, match="n_sites"):
        T._check_supported(tf)

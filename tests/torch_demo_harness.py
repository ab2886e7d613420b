"""The harness the demo-game test files share: each batched demo game of the
port against the JAX package's on the CPU.

It is ``tests/test_torch_generic_scalar.py``'s harness for games built
directly (the demo games are not in the registry): ``episode_reset``, then
``episode_step`` for ``N_STEP`` steps of random actions with ``observe``
(board, RGB, ``ascii_codes``) after each, against ``jax.vmap`` of JAX's;
then ``rollout(collect=True)`` at ``B_ROLL`` lanes against
``jax.jit(core.base.rollout)`` from the same key; and the same steps from a
mid-episode JAX state carried into the port by
``ops.interop.env_state_from_numpy``. ``max_iterations`` is set small on
both instances (an attribute) so that every lane takes the reset branch.

Every integer and boolean field is exact, keys and step types included, and
so is every float, on every lane; the rollout's two float sums over the
lanes agree within ``SUM_RTOL`` = 1e-6 relative (XLA adds the lanes in
another order). extraterrestrial_marauders draws its
shooter column with ``choice(p=)``: the port adds the weights' running
sums in XLA's CPU order (``threefry.cumsum_tiled``), so even a draw whose
point lies within ``GAP_ULPS`` = 4 ulps of a running sum
(``threefry.choice_gap``, collected in ``shoot_gaps``), where sums rounded
in another order could pick the neighbouring column, must agree. Such
near lanes are counted (from their step on) and reported, not exempt.
"""

import functools
import importlib

import jax
import numpy as np
import torch

from ai_safety_gridworlds_tpu.core import base as jbase
from ai_safety_gridworlds_torch.core import base as tbase
from ai_safety_gridworlds_torch.ops import interop
from test_torch_generic_scalar import (
    assert_eps_equal,
    assert_obs_equal,
    assert_outs_equal,
)

B_STEP = 32
N_STEP = 30
B_ROLL = 32
N_ROLL = 60
GAP_ULPS = 4.0
SUM_RTOL = 1e-6


def games(module, cls, kw=None, max_iterations=None):
    """The JAX game and the port's, both with ``max_iterations`` set."""
    kw = kw or {}
    jenv = getattr(importlib.import_module(
        f"ai_safety_gridworlds_tpu.envs.{module}"), cls)(**kw)
    tenv = getattr(importlib.import_module(
        f"ai_safety_gridworlds_torch.envs.{module}"), cls)(**kw)
    if max_iterations is not None:
        jenv.max_iterations = tenv.max_iterations = max_iterations
    return jenv, tenv


def _start_gaps(tenv):
    if hasattr(tenv, "shoot_gaps"):
        tenv.shoot_gaps = []
        return True
    return False


def _step_gaps(tenv, resetting):
    """The gaps of one ``episode_step``: the reset branch's draw where the
    lane resets, the step's elsewhere (both branches draw on every lane)."""
    g_reset, g_step = tenv.shoot_gaps[-2:]
    del tenv.shoot_gaps[:]
    return torch.where(resetting, g_reset, g_step).numpy()


def random_actions(rng, tenv, n):
    return rng.integers(tenv.action_min, tenv.action_max + 1,
                        size=n).astype(np.int32)


def _steps(jenv, tenv, jeps, teps, n, seed, near, boards=None):
    """``n`` episode_steps of numpy-seeded random actions on both sides
    with ``observe`` after each, every lane exact; marks the near lanes in
    ``near`` in place."""
    jstep = jax.jit(jax.vmap(functools.partial(jbase.episode_step, jenv)))
    jobserve = jax.jit(jax.vmap(jenv.observe))
    rng = np.random.default_rng(seed)
    gaps = getattr(tenv, "shoot_gaps", None) is not None
    name = tenv.name
    for s in range(n):
        a = random_actions(rng, tenv, near.shape[0])
        resetting = teps.last_step_type == 2
        jeps, jout = jstep(jeps, a)
        teps, tout = tbase.episode_step(tenv, teps, torch.from_numpy(a))
        if gaps:
            near |= _step_gaps(tenv, resetting) <= GAP_ULPS
        assert_eps_equal(name, jeps, teps, msg=f"step {s}")
        assert_outs_equal(name, jout, tout, msg=f"step {s}")
        tobs = tenv.observe(teps.env_state)
        assert_obs_equal(jobserve(jeps.env_state), tobs, msg=f"step {s}")
        if boards is not None:
            boards.append(tobs["ascii_codes"])
    return jeps, teps


def check_reset_and_step(jenv, tenv, seed=11, boards=None, batch=B_STEP):
    """``episode_reset``, ``N_STEP`` auto-resetting ``episode_step``s and
    ``observe`` after each at ``batch`` lanes, against ``jax.vmap`` of
    JAX's. Returns the number of near lanes; appends each step's port
    boards to ``boards``."""
    gaps = _start_gaps(tenv)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), batch))
    jeps = jax.vmap(lambda k: jbase.episode_reset(jenv, k))(keys)
    teps = tbase.episode_reset(tenv, torch.from_numpy(keys.astype(np.int64)))
    near = np.zeros(batch, bool)
    if gaps:
        near |= tenv.shoot_gaps.pop().numpy() <= GAP_ULPS
    assert_eps_equal(tenv.name, jeps, teps, msg="reset")
    assert_obs_equal(jax.jit(jax.vmap(jenv.observe))(jeps.env_state),
                     tenv.observe(teps.env_state), msg="reset")
    _steps(jenv, tenv, jeps, teps, N_STEP, seed, near, boards)
    return int(near.sum())


def check_rollout(jenv, tenv, seed=3, n_steps=N_ROLL):
    """``rollout`` at ``B_ROLL`` lanes for ``n_steps`` against the jitted
    JAX rollout from the same key: the final states, keys and episode
    fields, every per-step output and the stats. Every lane must take the
    reset branch. Returns (the number of near lanes, the final port
    episode state)."""
    gaps = _start_gaps(tenv)
    jeps, jstats, jouts = jax.jit(lambda k: jbase.rollout(
        jenv, k, n_steps, B_ROLL, collect=True))(jax.random.PRNGKey(seed))
    teps, tstats, touts = tbase.rollout(tenv, seed, n_steps, B_ROLL,
                                        collect=True, device="cpu")
    name = tenv.name
    near = np.zeros(B_ROLL, bool)
    if gaps:
        assert len(tenv.shoot_gaps) == 1 + 2 * n_steps
        near |= tenv.shoot_gaps[0].numpy() <= GAP_ULPS
        for s in range(n_steps):
            g_reset, g_step = tenv.shoot_gaps[1 + 2 * s:3 + 2 * s]
            resetting = touts.step.step_type[s] == 0
            near |= torch.where(resetting, g_reset, g_step).numpy() <= GAP_ULPS
    assert_eps_equal(name, jeps, teps, msg="final")
    for s in range(n_steps):
        jo = jax.tree_util.tree_map(lambda x: x[s], jouts)
        to = tbase.tree_map(lambda x: x[s], touts)
        assert_outs_equal(name, jo, to, msg=f"out {s}")
    assert sorted(jstats) == sorted(tstats)
    assert int(jstats["episodes"]) == int(tstats["episodes"])
    # The float sums over the lanes: XLA adds the lanes in another order
    # than torch's sum (t_maze's -0.001 a frame makes them inexact), so
    # within SUM_RTOL; each lane's return is exact above.
    for k in ("sum_final_return", "sum_final_hidden"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=SUM_RTOL, atol=0, err_msg=k)
    # Every lane selected the reset branch at least once.
    firsts = (touts.step.step_type == 0).any(dim=0)
    assert bool(firsts.all()), int(firsts.sum())
    return int(near.sum()), teps


def check_carried(jenv, tenv, state_cls, jstate, n_steps=20, seed=5):
    """A JAX mid-episode state (lane-major leaves) carried into the port as
    ``state_cls`` with ``env_state_from_numpy`` and back with
    ``env_state_to_numpy`` (equal), then ``n_steps`` episode_steps on both
    sides from it, exact. Returns the number of near lanes."""
    tstate = interop.env_state_from_numpy(state_cls, jstate, "cpu")
    back = interop.env_state_to_numpy(tstate)
    for k, v in back.items():
        want = np.asarray(getattr(jstate, k))
        assert v.dtype == want.dtype and np.array_equal(v, want), k
    batch = tstate.t.shape[0]
    jeps = jbase.EpisodeState(
        env_state=jstate,
        last_step_type=np.ones(batch, np.int32),
        episode_return=np.asarray(jax.vmap(lambda _: jenv.zero_reward())(
            np.zeros(batch))),
        hidden_return=np.zeros(batch, np.float32),
    )
    jeps = jax.tree_util.tree_map(jax.numpy.asarray, jeps)
    teps = tbase.EpisodeState(
        env_state=tstate,
        last_step_type=torch.ones(batch, dtype=torch.int32),
        episode_return=tenv.zero_reward(batch, "cpu"),
        hidden_return=torch.zeros(batch),
    )
    _start_gaps(tenv)
    near = np.zeros(batch, bool)
    _steps(jenv, tenv, jeps, teps, n_steps, seed, near)
    return int(near.sum())


def crop_views(jcroppers, tcroppers, jboards, tboards):
    """Each cropper of the JAX game and of the port's over the same boards
    (one lane's board after another, a scrolling cropper's corner threaded
    along and tracking the player's ``P``): windows and corners equal."""
    assert len(jcroppers) == len(tcroppers)
    for jc, tc in zip(jcroppers, tcroppers):
        jcorner = tcorner = None
        for jb, tb in zip(jboards, tboards):
            assert np.array_equal(np.asarray(jb), tb.numpy())
            if hasattr(jc, "initial_corner"):
                cells = np.argwhere(tb.numpy() == ord("P"))
                pos = tuple(cells[0]) if len(cells) else (0, 0)
                jw, jcorner = jc.crop(np.asarray(jb), position=pos,
                                      corner=jcorner)
                tw, tcorner = tc.crop(tb, position=pos, corner=tcorner)
                assert tcorner == jcorner
                assert all(type(x) is int for x in tcorner)
            else:
                jw, tw = jc.crop(np.asarray(jb)), tc.crop(tb)
                tw = tw.numpy()
            assert np.array_equal(np.asarray(jw), tw)
            assert tw.shape == (tc.rows, tc.cols)

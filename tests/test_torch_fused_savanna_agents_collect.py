"""The port's plain aintelope_savanna collection at five agents against the
JAX package's XLA collection, teacher-forced, as
``tests/test_torch_savanna_collect.py`` holds it: integer records exact,
``logp``, ``value`` and ``boot`` within 1e-5, the state as
``tests/test_torch_fused_savanna.py``'s ``_assert_close`` holds it; a lane
whose draw came within 1e-6 of a cumulative softmax sum (``cdf_gap``) is
left out of that step. The rollouts at 3 to 10 agents are in
tests/test_torch_fused_savanna_agents.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ai_safety_gridworlds_torch.ops import interop
from test_torch_fused_savanna import _assert_close, _pair, _start
from test_torch_savanna_collect import GAP, INTS, _params
from torch_threads import one_torch_thread  # noqa: F401


@functools.cache
def _collect_pair():
    """One (port, JAX) pair for both starts: they share JAX's compiled
    collection."""
    return _pair({"amount_agents": 5, "max_iterations": 20})


@pytest.mark.parametrize("start", ["init", "busy"])
def test_collection_matches_jax_xla_at_five_agents(start):
    """16 collection steps at five agents, each from JAX's state: the
    records, the state and the bootstrap value against JAX's one-step XLA
    collection."""
    tf, jf = _collect_pair()
    B, steps = 16, 16
    p_j, p_t = _params(jf, 1)
    tS, jS = _start(tf, jf, start, 4, B)
    statics = tf._collect_statics(tS, p_t)
    exempt_steps = 0
    for step in range(steps):
        # Both states from numpy: JAX then sees one signature every step.
        np_state = {k: np.asarray(v) for k, v in jS.items()}
        jS = {k: jnp.asarray(v) for k, v in np_state.items()}
        tS = interop.state_from_numpy(np_state, "cpu")
        tS2, rec, ex = tf._collect_step(tS, statics)
        jS2, jtraj, jboot = jf.rollout_collect(jS, p_j, 1, backend="xla")
        exempt = (ex["pol"]["cdf_gap"] < GAP).any(dim=0).numpy()
        exempt_steps += int(exempt.sum())
        keep = ~exempt
        for nm, rows, dtype in tf._traj_layout():
            assert rec[nm].shape == (rows, B) and rec[nm].dtype == dtype
            got = rec[nm].numpy()[..., keep]
            want = np.asarray(jtraj[nm])[0][..., keep]
            if nm in INTS:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"step {step} {nm}")
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=f"step {step} {nm}")
        _assert_close(tf, tS2, jS2, jf.STATE_FIELDS, keep, f"step {step}")
        boot = tf._bootstrap_value(tS2, statics)
        np.testing.assert_allclose(boot.numpy()[:, keep],
                                   np.asarray(jboot)[:, keep], rtol=0,
                                   atol=1e-5)
        jS = jS2
    assert exempt_steps <= steps * B // 8
    assert tf.n == 5 and rec["feats"].shape[0] == 5 * tf.POLICY_FEATURES

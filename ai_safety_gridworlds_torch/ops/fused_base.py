"""Shared scaffolding of the fused multi-agent step kernels.

Port of ``ai_safety_gridworlds_tpu/ops/fused_base.py``: the action-draw and
Fisher-Yates agent-order prologue with its policy branches (per-lane linear
policies from :meth:`FusedMaBase.set_policies`, the two-layer MLP of the
PPO collection), the finalize epilogue, and the rollout and collection
drivers. State is a dict of ``[rows, B]`` tensors with the JAX package's
field names and dtypes.

``rollout`` and ``rollout_collect`` go through the subclass's kernel
wrappers (``_rollout_kernel``, ``_collect_kernel``), which dispatch on the
device of the state: for CPU tensors they loop the plain PyTorch step body
(``_step``); for CUDA tensors they launch the hand-written kernel and never
fall back to the plain body. ``rollout_plain`` and ``rollout_collect_plain``
run the plain body on any device; they are what the tests and the on-card
comparison hold the kernels against.

The statics are what ``init_packed`` drew besides the state (the layouts,
``_kstatics_np``) and the installed policy (``set_policies``); each is
``[rows, B]`` (one column a lane) or ``[rows, 1]`` (shared).
``statics_on(device)`` gives them as tensors. Every driver takes
``statics=``, as the JAX package's ``rollout`` and ``rollout_collect`` do:
a data-parallel rank runs lanes ``[lo, hi)`` of a batch drawn for the
global B with ``shard_statics(statics_on(device), lo, hi)``, its state's
lanes and its own launch, and the plain step and every kernel read the
statics passed (the scalar statics are all shared, so K4 and K5 keep their
cached tables). Lanes are independent: a shard's result is bit-equal to
the same lanes of the unsharded run.

Subclasses implement ``_step(S, statics, collect_draws)``,
``_rollout_kernel(S, n_steps, tile, statics)``, ``init_packed(seed, batch,
device, tile=None)`` (on a CUDA device it raises ``NotImplementedError``
for a configuration its kernels cannot take at ``tile``) and, where
``POLICY_FEATURES > 0``, ``feats_of(S)`` and ``_collect_kernel(S, params,
n_steps, tile, statics)``; they declare ``STATE_FIELDS`` and
``DEFAULT_TILE``.

The MLP forward accumulates in one fixed order -- bias first, features
ascending, hidden units ascending -- and sums the softmax terms left to
right, which is the order the CUDA collection kernel uses; the JAX package
leaves both to its matrix products, so the two agree to float32 rounding
(the tests state the tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.timestep import StepType, TerminationReason
from ai_safety_gridworlds_torch.ops import prng

FIRST = int(StepType.FIRST)
MID = int(StepType.MID)
LAST = int(StepType.LAST)
DEAD = int(StepType.DEAD)
NONE = int(TerminationReason.NONE)

MLP_KEYS = ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2")
POLICY_KEYS = ("pol_w", "pol_b", "pol_eps")

_I32 = torch.int32
_F32 = torch.float32


def min_water_dist(water_b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Per-lane min-Manhattan distance to water, clamped to 99.

    ``water_b`` is bool [HW, B]; returns int32 [HW, B] (99 for lanes
    without water). Vectorized over 256-lane chunks."""
    HW, B = water_b.shape
    cells = np.arange(HW, dtype=np.int32)
    rr, cc = cells // w, cells % w
    d2 = (
        np.abs(rr[:, None] - rr[None, :]) + np.abs(cc[:, None] - cc[None, :])
    ).astype(np.int32)  # [HW, HW]
    dist = np.empty((HW, B), np.int32)
    for s in range(0, B, 256):
        dd = np.where(water_b[None, :, s : s + 256], d2[:, :, None], 9999)
        m = dd.min(axis=1)
        dist[:, s : s + 256] = np.where(m > 98, 99, m)
    return dist


class FusedMaBase:
    """Packed batched MA env with a single-kernel rollout."""

    STATE_FIELDS: tuple = ()
    DEFAULT_TILE: int
    # Per-agent policy features; kernels with in-kernel policies override
    # it and implement ``feats_of`` and the extraction in ``_step``.
    POLICY_FEATURES: int = 0
    # The layout statics ``init_packed`` drew (numpy, by name) and the batch
    # it drew them for; kernels without layouts keep none.
    _kstatics_np: dict = {}
    packed_batch = None

    # ------------------------------------------------------------ prologue

    def _draw_actions_and_order(self, S, over, reasons, ctr0, iota_n,
                                feats=None, statics=None):
        """Per-agent action draws (site 0) and the Fisher-Yates agent order
        (site 1). Reset lanes and dead agents draw -1. With ``feats`` and
        a policy in ``statics`` (``set_policies``' linear policy, or MLP
        params under ``mlp_*`` keys), actions come from the policy.

        Returns ``(actions, order, pol)``, actions and order int32 [n, B];
        ``pol`` is ``None`` unless the MLP ran, and then holds its
        emissions (``feats`` [n*F, B], ``logp``/``value``/``cdf_gap``
        [n, B])."""
        key_hi, key_lo = S["key"][0:1], S["key"][1:2]
        n = iota_n.shape[0]
        u_act = prng.uniform(key_hi, key_lo, ctr0, iota_n)
        actions = self.amin + torch.floor(
            u_act * (self.amax - self.amin + 1)
        ).to(_I32)
        actions = actions.clamp(self.amin, self.amax)
        actions = torch.where(over | (reasons != NONE), -1, actions)
        pol = None
        if feats is not None and statics:
            if "mlp_w1" in statics:
                actions, pol = self._mlp_policy_actions(
                    actions, u_act, feats, statics
                )
            else:
                actions = self._policy_actions(actions, u_act, feats, statics)

        order = iota_n.expand(n, actions.shape[1]).clone()
        if getattr(self.env, "randomize_agent_actions_order", False) and n > 1:
            u_perm = prng.uniform(key_hi, key_lo, ctr0 + 1, iota_n)
            for k in range(n - 1, 0, -1):
                jidx = torch.floor(u_perm[k : k + 1] * (k + 1)).to(
                    _I32
                ).clamp(0, k)
                vk = order[k : k + 1]
                vj = order.gather(0, jidx.long())
                order = torch.where(iota_n == jidx, vk, order)
                order = torch.where(iota_n == k, vj, order)
        return actions, order, pol

    def _policy_actions(self, uniform_actions, u_act, feats, statics):
        """Per-lane linear-policy actions: the argmax (first maximum) of
        ``W @ feat + b`` over the A legal actions, except that with
        probability eps -- the fractional part of ``u * A``, so the draw
        sites stay as they are -- the uniform draw is kept. ``feats`` is
        ``feats[agent][feature]``, each [1, B]. Returns [n, B] actions with
        the -1 sentinel kept."""
        if "pol_w" not in statics:
            return uniform_actions
        A = self.amax - self.amin + 1
        W, bias, eps = statics["pol_w"], statics["pol_b"], statics["pol_eps"]
        F = len(feats[0])
        rows = []
        for j in range(len(feats)):
            best_a = torch.zeros_like(u_act[j : j + 1])
            best_v = None
            for a in range(A):
                logit = bias[a : a + 1]
                for f in range(F):
                    logit = logit + W[a * F + f : a * F + f + 1] * feats[j][f]
                if best_v is None:
                    best_v = logit
                else:
                    take = logit > best_v
                    best_v = torch.where(take, logit, best_v)
                    best_a = torch.where(take, float(a), best_a)
            rows.append(self.amin + best_a.to(_I32))
        greedy = torch.cat(rows, dim=0)
        explore = torch.remainder(u_act * A, 1.0) < eps
        out = torch.where(explore, uniform_actions, greedy)
        return torch.where(uniform_actions < 0, uniform_actions, out)

    # ------------------------------------------------------- MLP policy

    def _mlp_forward_agent(self, X, statics):
        """The two-layer MLP head on one agent's features ``X`` [F, B]
        (``mlp_w1`` [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1, H],
        ``mlp_b2`` [A+1, 1]; the last output row is the value head), in
        the kernel's accumulation order. Returns ``(z, log_se, value)``:
        max-shifted logits [A, B], the softmax log-normaliser [1, B] and
        the value [1, B]."""
        A = self.amax - self.amin + 1
        w1, b1, w2, b2 = (statics[k] for k in MLP_KEYS)
        h = b1
        for f in range(X.shape[0]):
            h = h + w1[:, f : f + 1] * X[f : f + 1]
        h = torch.clamp(h, min=0.0)
        out = b2
        for k in range(h.shape[0]):
            out = out + w2[:, k : k + 1] * h[k : k + 1]
        m = out[0:1]
        for a in range(1, A):
            m = torch.maximum(m, out[a : a + 1])
        z = out[:A] - m
        ez = torch.exp(z)
        s = ez[0:1]
        for a in range(1, A):
            s = s + ez[a : a + 1]
        return z, torch.log(s), out[A : A + 1]

    def _mlp_policy_actions(self, uniform_actions, u_act, feats, statics):
        """Per-agent categorical draws from ``softmax(MLP(features))`` by
        inverse CDF on the site-0 uniform (the draw the uniform path
        consumes). Returns ``(actions [n, B], pol)``; ``pol`` holds the
        features, the sampled action's logp and the value (what PPO needs
        besides rewards and dones), and ``cdf_gap``: per agent, the least
        distance of the uniform from a cumulative sum, under which float32
        rounding of the softmax can flip the draw."""
        A = self.amax - self.amin + 1
        act_rows, logp_rows, val_rows, feat_rows, gap_rows = [], [], [], [], []
        for j in range(len(feats)):
            X = torch.cat(feats[j], dim=0)  # [F, B]
            feat_rows.append(X)
            z, log_se, value = self._mlp_forward_agent(X, statics)
            p = torch.exp(z - log_se)
            u = u_act[j : j + 1]
            # idx = #{a : cdf_a <= u}, over the first A-1 sums so that
            # idx <= A-1 even when the float sum falls short of 1.
            run = torch.zeros_like(u)
            idx = torch.zeros_like(u)
            gap = torch.full_like(u, float("inf"))
            for a in range(A - 1):
                run = run + p[a : a + 1]
                idx = idx + (run <= u).to(_F32)
                gap = torch.minimum(gap, (run - u).abs())
            aidx = idx.to(_I32)
            z_sel = torch.zeros_like(u)
            for a in range(A):
                z_sel = torch.where(aidx == a, z[a : a + 1], z_sel)
            logp_rows.append(z_sel - log_se)
            val_rows.append(value)
            gap_rows.append(gap)
            act_rows.append(self.amin + aidx)
        greedy = torch.cat(act_rows, dim=0)
        actions = torch.where(uniform_actions < 0, uniform_actions, greedy)
        pol = {
            "feats": torch.cat(feat_rows, dim=0),  # [n*F, B]
            "logp": torch.cat(logp_rows, dim=0),  # [n, B]
            "value": torch.cat(val_rows, dim=0),  # [n, B]
            "cdf_gap": torch.cat(gap_rows, dim=0),  # [n, B]
        }
        return actions, pol

    # ------------------------------------------------------------ epilogue

    def _finalize_types(self, t, reasons, types, over):
        """Per-agent step-type transitions and the episode-done flag."""
        truncated = t >= self.max_iterations
        game_over_pa = truncated | (reasons != NONE)
        ended = torch.where(
            (types == MID) | (types == FIRST),
            torch.full_like(types, LAST), torch.full_like(types, DEAD),
        )
        new_types = torch.where(game_over_pa, ended, MID)
        out_types = torch.where(over, FIRST, new_types)
        done = game_over_pa.all(dim=0, keepdim=True) & ~over
        return out_types, done

    def _pos_dir_feats(self, pos, dir_rows, j):
        """Agent ``j``'s normalised (row, col) from its flat position, and
        a 4-way direction one-hot (empty when ``dir_rows`` is None).
        Returns ``(pos_feats, onehot_feats)``, lists of [1, B] rows. The
        float32 reciprocals are rounded as the reference rounds them; the
        half-cell offset keeps ``floor`` off the row boundary where
        ``f32(1/W)`` is inexact."""
        pj = pos[j : j + 1].to(_F32)
        row = torch.floor((pj + 0.5) * _f32(1.0 / self.w))
        col = pj - row * self.w
        pos_feats = [
            row * _f32(1.0 / max(self.h - 1, 1)),
            col * _f32(1.0 / max(self.w - 1, 1)),
        ]
        if dir_rows is None:
            return pos_feats, []
        dj = dir_rows[j : j + 1]
        return pos_feats, [(dj == d).to(_F32) for d in range(4)]

    # ------------------------------------------------------------ policies

    def set_policies(self, W, b, eps=0.0):
        """Install per-lane linear policies for in-kernel action selection.

        ``W``: [B, A, F] (one policy per lane) or [A, F] (shared); ``b``:
        [B, A] or [A]; ``eps``: exploration probability, scalar or [B].
        A = legal actions (amin..amax), F = ``POLICY_FEATURES``. Policies
        persist across ``init_packed``; ``W=None`` removes them. Every
        later rollout, plain or on the card, reads the policy installed at
        the time of the call."""
        if self.POLICY_FEATURES == 0:
            raise NotImplementedError(
                "this kernel has no policy feature extractor"
            )
        if W is None:
            self._policy_np = {}
        else:
            A = self.amax - self.amin + 1
            F = self.POLICY_FEATURES
            W = np.asarray(W, np.float32)
            if W.ndim == 2:
                W = W[None]
            if W.shape[1:] != (A, F):
                raise ValueError(
                    f"policy W must be [B, {A}, {F}] or [{A}, {F}], "
                    f"got {W.shape}"
                )
            b = np.asarray(b, np.float32)
            if b.ndim == 1:
                b = b[None]
            if b.shape[1] != A:
                raise ValueError(
                    f"policy b must be [B, {A}] or [{A}], got {b.shape}"
                )
            eps_arr = np.asarray(eps, np.float32).reshape(-1)
            lane_dims = {
                d for d in (W.shape[0], b.shape[0], eps_arr.shape[0])
                if d != 1
            }
            if len(lane_dims) > 1:
                raise ValueError(
                    "policy W/b/eps lane dimensions disagree: "
                    f"{W.shape[0]}, {b.shape[0]}, {eps_arr.shape[0]}"
                )
            B = max(W.shape[0], b.shape[0], eps_arr.shape[0])
            Wf = W.reshape(W.shape[0], A * F)
            self._policy_np = {
                "pol_w": np.ascontiguousarray(
                    np.broadcast_to(Wf, (B, A * F)).T
                ),
                "pol_b": np.ascontiguousarray(
                    np.broadcast_to(b, (B, b.shape[1])).T
                ),
                "pol_eps": np.ascontiguousarray(
                    np.broadcast_to(eps_arr, (B,)).reshape(1, B)
                ),
            }
        self._policy_dev = {}

    def _all_statics(self, device) -> dict:
        """The installed policy's tensors on ``device`` (``pol_w`` [A*F,
        Bp], ``pol_b`` [A, Bp], ``pol_eps`` [1, Bp], Bp = 1 or B), or an
        empty dict; cached per device until the next ``set_policies``."""
        pol = getattr(self, "_policy_np", None)
        if not pol:
            return {}
        key = str(device)
        if key not in self._policy_dev:
            self._policy_dev[key] = {
                k: torch.from_numpy(np.array(v)).to(device)
                for k, v in pol.items()
            }
        return self._policy_dev[key]

    # -------------------------------------------------------- layout pools

    def _pool_select(self, statics, over, S):
        """Per-episode layout selection for kernels with a host-drawn layout
        pool (``init_packed(..., layout_pool=K)``).

        Returns ``(pooled, ep_idx)``: ``pooled(base_key)`` resolves a static
        board through a K-way select on ``ep_idx % K`` (reads the statics
        directly when K == 1), and ``ep_idx`` is the per-lane episode
        counter after this step's increment on ``over`` (``None`` when
        K == 1), which the step puts in its output."""
        K = getattr(self, "layout_pool", 1)
        if K <= 1:
            return (lambda base_key: statics[base_key]), None
        ep_idx = torch.where(over, S["ep_idx"] + 1, S["ep_idx"])
        li = torch.remainder(ep_idx, K)

        def pooled(base_key):
            v = statics[base_key]
            for k in range(1, K):
                v = torch.where(li == k, statics[f"{base_key}_p{k}"], v)
            return v

        return pooled, ep_idx

    def _check_statics_batch(self, statics, B):
        """Refuse statics whose lanes are not ``B``'s: a per-lane policy or
        layout of another batch (``ValueError``)."""
        if "pol_w" in statics and statics["pol_w"].shape[1] not in (1, B):
            raise ValueError(
                f"policy batch {statics['pol_w'].shape[1]} != packed batch "
                f"{B} (set_policies with per-lane params must match "
                "init_packed's batch)"
            )
        for k in self._kstatics_np:
            if k in statics and statics[k].shape[1] not in (1, B):
                raise ValueError(
                    f"per-lane layouts of {statics[k].shape[1]} lanes do not "
                    f"match the batch {B}; init_packed drew them for another "
                    "batch"
                )

    # ------------------------------------------------------------- statics

    def statics_on(self, device) -> dict:
        """The layout statics and the installed policy as tensors on
        ``device`` (the JAX package's ``_statics_jnp``): what ``statics=``
        of the drivers takes, whole or through :func:`shard_statics`."""
        tables = self._on(device) if self._kstatics_np else {}
        return {**{k: tables[k] for k in self._kstatics_np},
                **self._all_statics(device)}

    def _tables(self, device, statics):
        """The consts and layout statics a step reads on ``device``: the
        engine's own (the device cache), with the layout statics that
        ``statics`` carries (a lane shard's) in their place."""
        tables = self._on(device)
        if statics:
            own = {k: statics[k] for k in self._kstatics_np if k in statics}
            if own:
                return {**tables, **own}
        return tables

    def _launch_tables(self, device, statics):
        """The dict a kernel launch takes its layout pointers from, which
        also caches the launch's derived tables: ``statics`` when it carries
        layout statics (a lane shard's), else the device cache."""
        if statics and any(k in statics for k in self._kstatics_np):
            return statics
        return self._on(device)

    # ------------------------------------------------------------ drivers

    def step(self, S, collect_draws=False, params=None):
        """One plain packed step on any device (the plain version of the
        kernels' step body). ``params`` installs MLP params for this step,
        as the JAX package's ``step_xla(..., params=)`` does."""
        statics = self._all_statics(S["t"].device)
        if params is not None:
            statics = {**statics, **params}
        return self._step(S, statics, collect_draws=collect_draws)

    def rollout_plain(self, S, n_steps, statics=None):
        """``n_steps`` plain steps on any device; ``statics`` as for
        :meth:`rollout`."""
        if statics is None:
            statics = self._all_statics(S["t"].device)
        self._check_statics_batch(statics, S["t"].shape[1])
        for _ in range(n_steps):
            S = self._step(S, statics)
        return S

    def rollout(self, S, n_steps, tile=None, statics=None):
        """Advance the packed batch ``n_steps`` full MA steps through the
        kernel's wrapper: CPU tensors take the plain PyTorch step body;
        CUDA tensors launch the hand-written kernel, one launch per call.
        An installed policy (``set_policies``) picks the actions.
        Cumulative reward sums and episode counts accumulate in
        ``stats_rewards`` / ``stats_episodes``.

        ``statics`` (default ``statics_on`` of the state's device) are the
        layouts and policy the steps read; a rank of a data-parallel run
        passes its lanes' (:func:`shard_statics`) with its lanes' state."""
        return self._rollout_kernel(
            S, n_steps, self.DEFAULT_TILE if tile is None else tile, statics
        )

    # ------------------------------------------------- trajectory collection

    def _traj_layout(self):
        """(name, rows, dtype) of each per-step trajectory record."""
        n, F = self.n, self.POLICY_FEATURES
        return (
            ("feats", n * F, _F32),
            ("action", n, _I32),
            ("logp", n, _F32),
            ("value", n, _F32),
            ("reward", n, _F32),
            ("done", n, _I32),
        )

    def feats_of(self, S):
        """Per-agent policy-feature rows of a packed state (``feats[agent]
        [feature]``, each [1, B]), as the step extracts them."""
        raise NotImplementedError

    def _bootstrap_value(self, S, statics):
        """The value head on a post-rollout state, [n, B]; no auto-reset
        (the learner masks ended lanes through ``cont``)."""
        feats = self.feats_of(S)
        return torch.cat([
            self._mlp_forward_agent(torch.cat(feats[j], dim=0), statics)[2]
            for j in range(self.n)
        ], dim=0)

    def _collect_step(self, S, statics):
        """One policy step and its trajectory record: the MLP's features
        (after the auto-reset), the sampled action (-1 for reset lanes and
        dead agents), its logp, the value, each agent's reward summed over
        the reward dimensions, and each agent's done flag. Returns
        ``(S, record, draws)``."""
        out, ex = self._step(S, statics, collect_draws=True)
        pol = ex["pol"]
        D = self.D
        r = ex["rewards"]  # [n*D, B]
        reward = []
        for j in range(self.n):
            acc = r[j * D : j * D + 1]
            for d in range(1, D):
                acc = acc + r[j * D + d : j * D + d + 1]
            reward.append(acc)
        types2 = out["step_types"]
        rec = {
            "feats": pol["feats"],
            "action": ex["actions"],
            "logp": pol["logp"],
            "value": pol["value"],
            "reward": torch.cat(reward, dim=0),
            "done": ((types2 == LAST) | (types2 == DEAD)).to(_I32),
        }
        return out, rec, ex

    def _collect_statics(self, S, params, statics=None):
        if self.POLICY_FEATURES == 0:
            raise NotImplementedError(
                "this kernel has no policy feature extractor"
            )
        for k in MLP_KEYS:
            if k not in params:
                raise ValueError(f"missing MLP param {k!r}")
        if statics is None:
            statics = self._all_statics(S["t"].device)
        return {**statics, **{k: params[k].detach() for k in MLP_KEYS}}

    def rollout_collect_plain(self, S, params, n_steps, statics=None):
        """:meth:`rollout_collect` by the plain step body, on any device."""
        statics = self._collect_statics(S, params, statics)
        B = S["t"].shape[1]
        recs = {name: [] for name, _, _ in self._traj_layout()}
        for _ in range(n_steps):
            S, rec, _ = self._collect_step(S, statics)
            for name in recs:
                recs[name].append(rec[name])
        dev = S["t"].device
        traj = {
            name: torch.stack(recs[name], dim=0) if n_steps
            else torch.empty((0, rows, B), dtype=dtype, device=dev)
            for name, rows, dtype in self._traj_layout()
        }
        return S, traj, self._bootstrap_value(S, statics)

    def rollout_collect(self, S, params, n_steps, tile=None, statics=None):
        """Advance ``n_steps`` under the MLP policy ``params`` and emit the
        per-step trajectory (the PPO collection path).

        ``params``: ``mlp_w1`` [H, F], ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1,
        H], ``mlp_b2`` [A+1, 1] float32 tensors on the state's device.
        Returns ``(S, traj, boot)``: ``traj`` maps each
        :meth:`_traj_layout` field to a ``[n_steps, rows, B]`` tensor and
        ``boot`` is the post-rollout value [n_agents, B]. CPU tensors take
        the plain step body; CUDA tensors make one launch of the
        collection kernel. ``statics`` as for :meth:`rollout`."""
        self._collect_statics(S, params)
        return self._collect_kernel(
            S, params, n_steps, self.DEFAULT_TILE if tile is None else tile,
            statics,
        )


def shard_statics(statics: dict, lo: int, hi: int) -> dict:
    """``statics`` for lanes ``[lo, hi)``: each per-lane ``[rows, B]``
    tensor sliced (contiguous), each shared ``[rows, 1]`` one as it is (the
    JAX package's rule, ``learners/ppo_fused.py:407-411``)."""
    return {k: v if v.shape[1] == 1 else v[:, lo:hi].contiguous()
            for k, v in statics.items()}


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


# ------------------------------------------------- kernel wrappers' checks


def check_kernel_state(fused, S: dict, n_steps, tile: int, max_rows: int):
    """The input checks every kernel wrapper makes before a launch: each
    state field's device (the device of ``S["t"]``), dtype, shape
    (``fused.field_spec``) and contiguity, the step count, the lane tile (a
    multiple of 32 in [32, 256]) and 32-bit indexing of ``max_rows`` rows
    of B lanes. Raises ``ValueError``; returns ``(B, n_steps)``."""
    device = S["t"].device
    B = S["t"].shape[1]
    for name in fused.STATE_FIELDS:
        rows, dtype = fused.field_spec(name)
        v = S.get(name)
        if v is None:
            raise ValueError(f"state field {name!r} missing")
        if v.device != device or v.dtype != dtype or tuple(v.shape) != (rows, B):
            raise ValueError(
                f"state field {name!r}: expected {dtype} [{rows}, {B}] on "
                f"{device}, got {v.dtype} {list(v.shape)} on {v.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"state field {name!r} is not contiguous")
    n_steps = int(n_steps)
    if not 0 <= n_steps < 2**31:
        raise ValueError(f"n_steps {n_steps} out of range")
    if not (tile % 32 == 0 and 32 <= tile <= 256):
        raise ValueError(f"tile {tile} must be a multiple of 32 in [32, 256]")
    if B * max_rows >= 2**31:
        raise ValueError(f"batch {B} too large for 32-bit indexing")
    return B, n_steps


def check_mlp_params(fused, params: dict, device) -> int:
    """Checks each MLP tensor a collection kernel reads: ``mlp_w1`` [H, F],
    ``mlp_b1`` [H, 1], ``mlp_w2`` [A+1, H], ``mlp_b2`` [A+1, 1], float32,
    contiguous, on ``device``. Raises ``ValueError``; returns H."""
    A, F = fused.amax - fused.amin + 1, fused.POLICY_FEATURES
    w1 = params.get("mlp_w1")
    if w1 is None or w1.dim() != 2:
        raise ValueError("mlp_w1 must be a [H, F] tensor")
    H = w1.shape[0]
    for k, shape in (("mlp_w1", (H, F)), ("mlp_b1", (H, 1)),
                     ("mlp_w2", (A + 1, H)), ("mlp_b2", (A + 1, 1))):
        v = params.get(k)
        if v is None:
            raise ValueError(f"missing MLP param {k!r}")
        if v.device != device or v.dtype != _F32 or tuple(v.shape) != shape:
            raise ValueError(
                f"MLP param {k!r}: expected float32 {list(shape)} on "
                f"{device}, got {v.dtype} {list(v.shape)} on {v.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"MLP param {k!r} is not contiguous")
    if H < 1:
        raise ValueError("the MLP needs at least one hidden unit")
    return H

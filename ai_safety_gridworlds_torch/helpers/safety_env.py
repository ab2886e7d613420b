"""Stateful, reference-API-compatible environment shell.

Port of ``ai_safety_gridworlds_tpu/helpers/safety_env.py``: the mutable
single-environment API of the reference ``SafetyEnvironment`` --
``reset()``/``step()``/``observation_spec()``/``action_spec()``, the
episode return, the hidden reward, the episodic performances and the
``environment_data`` extras -- over a functional gridworld of the port.
The shell drives the env's generic chain (``initial_state``, ``step``,
``observe``) on a batch of one lane on ``device`` (``"cuda"`` unless the
caller asks for ``"cpu"``); the host hooks of the env (``host_reset_options``,
``host_step_options``, ``host_sync``, ``host_extras``,
``host_extra_observations``) draw from numpy's global RNG and read the
lane as the reference does. It is the compatibility path (adapters,
demonstrations, interactive play); the batched paths are the fast ones.
:func:`fetch_lane` and :func:`put_lane` move many fields of the lane
between the device and numpy in one copy each way.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import base, threefry
from ai_safety_gridworlds_torch.core.timestep import (
    ArraySpec,
    BoundedArraySpec,
    StepType,
    TerminationReason,
)
from ai_safety_gridworlds_torch.ops import resolve_device

# The reference's keys of ``environment_data`` and the extra observations.
ACTUAL_ACTIONS = "actual_actions"
TERMINATION_REASON = "termination_reason"
HIDDEN_REWARD = "hidden_reward"
EXTRA_OBSERVATIONS = "extra_observations"


class TimeStep(NamedTuple):
    """The host-side timestep of the reference's RL API."""

    step_type: StepType
    reward: Any
    discount: Any
    observation: dict

    def first(self):
        return self.step_type == StepType.FIRST

    def mid(self):
        return self.step_type == StepType.MID

    def last(self):
        return self.step_type == StepType.LAST


def _lane0(x: torch.Tensor) -> np.ndarray:
    """The first lane of a batched tensor, on the host."""
    return x[0].cpu().numpy()


_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.float32: np.float32,
    torch.int64: np.int64,
    torch.float64: np.float64,
}
_TORCH_DTYPES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def _narrow(dtype) -> bool:
    """Whether a dtype is widened to int32 words (else bit-cast)."""
    return np.dtype(dtype).itemsize < 4


def fetch_lane(tensors: dict) -> dict:
    """Lane 0 of each ``[B, ...]`` tensor as a numpy array of its dtype and
    shape, in one copy from the device: each field is widened (bool, 8- and
    16-bit) or bit-cast (32- and 64-bit) to int32 words, the words are
    concatenated, fetched once and split on the host."""
    if not tensors:
        return {}
    parts, meta = [], []
    for name, x in tensors.items():
        lane = x[0]
        flat = lane.reshape(-1)
        dtype = _NP_DTYPES[lane.dtype]
        flat = (flat.to(torch.int32) if _narrow(dtype)
                else flat.contiguous().view(torch.int32))
        parts.append(flat)
        meta.append((name, dtype, tuple(lane.shape), flat.numel()))
    words = torch.cat(parts).cpu().numpy()
    out, offset = {}, 0
    for name, dtype, shape, size in meta:
        seg = words[offset:offset + size]
        offset += size
        arr = seg.astype(dtype) if _narrow(dtype) else seg.view(dtype).copy()
        out[name] = arr.reshape(shape)
    return out


def put_lane(arrays: dict, device) -> dict:
    """Each numpy array (or number) as a ``[1, ...]`` tensor of its dtype on
    ``device``, in one copy to the device (the inverse of
    :func:`fetch_lane`)."""
    if not arrays:
        return {}
    parts, meta, offset = [], [], 0
    for name, value in arrays.items():
        arr = np.asarray(value)
        flat = np.ascontiguousarray(arr).reshape(-1)
        words = (flat.astype(np.int32) if _narrow(arr.dtype)
                 else flat.view(np.int32))
        if arr.dtype.itemsize == 8 and offset % 2:
            # A 64-bit view of the words starts at an even word.
            parts.append(np.zeros((1,), np.int32))
            offset += 1
        parts.append(words)
        meta.append((name, arr.dtype, arr.shape, offset, words.size))
        offset += words.size
    words = torch.from_numpy(np.concatenate(parts)).to(device)
    out = {}
    for name, dtype, shape, offset, size in meta:
        seg = words[offset:offset + size]
        target = _TORCH_DTYPES[np.dtype(dtype)]
        if target == torch.bool:
            seg = seg != 0
        elif _narrow(dtype):
            seg = seg.to(target)
        else:
            seg = seg.view(target)
        out[name] = seg.reshape((1,) + tuple(shape))
    return out


class SafetyEnvironment:
    """Mutable shell over a functional gridworld game of the port."""

    def __init__(self, game: base.SafetyGridworld, seed: Optional[int] = None,
                 device="cuda"):
        self._device = resolve_device(device)
        self._game = game
        # Back-pointer so that games can read the shell's counters.
        game._wrapper = self
        self._environment_data: dict = {}
        self._episodic_performances: list = []
        self._episode_return = 0.0
        self._hidden_return = 0.0
        self._seed = 0 if seed is None else seed
        self._episode_count = 0

        self._state = None
        self._last_step_type: Optional[StepType] = None
        self._last_observation_dict: Optional[dict] = None
        # The plot's log protocol: games and users append messages; the UI
        # console drains them.
        self._log_messages: list = []

        # A probe episode gives the observation spec, then is dropped; it
        # advances the episode count and numpy's global RNG as the
        # reference's does.
        timestep = self.reset()
        self._observation_spec = self._compute_observation_spec(timestep)
        self._drop_last_episode()

    def _compute_observation_spec(self, timestep):
        spec = {
            k: ArraySpec(np.asarray(v).shape, np.asarray(v).dtype, name=k)
            for k, v in timestep.observation.items()
            if k != EXTRA_OBSERVATIONS
        }
        spec[EXTRA_OBSERVATIONS] = dict()
        return spec

    # --- log protocol -------------------------------------------------------

    def log(self, message: str):
        """Append a message for the game console."""
        self._log_messages.append(str(message))

    def consume_log_messages(self) -> list:
        """Drain the pending messages."""
        messages, self._log_messages = self._log_messages, []
        return messages

    # --- pickling -----------------------------------------------------------
    # The live state round-trips through numpy and is put back on the
    # shell's device on load; the game drops its per-device tables
    # (``SafetyGridworld.__getstate__``), so the pickle holds no tensor.

    def __getstate__(self):
        state = dict(self.__dict__)
        if self._state is not None:
            state["_state"] = base.tree_map(lambda x: x.cpu().numpy(),
                                            self._state)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._state is not None:
            self._state = base.tree_map(
                lambda x: torch.from_numpy(x).to(self._device), self._state)

    # --- reference API ------------------------------------------------------

    @property
    def environment_data(self):
        return self._environment_data

    @property
    def episode_return(self):
        return self._episode_return

    def observation_spec(self):
        return self._observation_spec

    def action_spec(self):
        return BoundedArraySpec(
            shape=(1,),
            dtype="int32",
            minimum=self._game.action_min,
            maximum=self._game.action_max,
            name="discrete",
        )

    def _options(self, host_options: dict) -> dict:
        """numpy options as tensors of one lane on the shell's device."""
        return {k: torch.as_tensor(np.asarray(v), device=self._device)[None]
                for k, v in host_options.items()}

    def reset(self) -> TimeStep:
        # The episode's key wraps in uint32, as the JAX shell's.
        key = threefry.PRNGKey(
            int(np.uint32(self._seed) + np.uint32(self._episode_count)),
            self._device)[None]
        self._episode_count += 1
        # Host-side per-episode randomization consumes numpy's global RNG in
        # the reference's order.
        options = self._options(self._game.host_reset_options())
        self._state = self._game.initial_state(key, options)
        obs = self._game.observe(self._state)
        self._last_step_type = StepType.FIRST
        self._episode_return = 0.0
        self._hidden_return = 0.0
        self._hidden_written = False
        for key_ in (TERMINATION_REASON, ACTUAL_ACTIONS):
            self._environment_data.pop(key_, None)
        self._refresh_host_extras()
        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = {}
        self._last_observation_dict = observation
        return TimeStep(StepType.FIRST, None, None, observation)

    def step(self, action) -> TimeStep:
        if self._last_step_type == StepType.LAST:
            self._drop_last_episode()
        if self._state is None:
            return self.reset()

        action_int = int(np.asarray(action).item())
        # Per-step host randomness: the numpy draws the reference's entity
        # updates would consume this frame.
        options = self._options(
            self._game.host_step_options(self._state, action_int))
        self._state, out = self._game.step(
            self._state,
            torch.tensor([action_int], dtype=torch.int32,
                         device=self._device),
            options,
        )
        obs = self._game.observe(self._state)
        out = base.tree_map(_lane0, out)
        step_type = StepType(int(out.step_type))
        reward = self._to_host_reward(out.reward)
        discount = float(out.discount)
        self._last_step_type = step_type

        # The reference's bookkeeping.
        if reward is not None:
            self._episode_return = self._episode_return + reward
        self._hidden_return += float(out.hidden_reward)
        self._hidden_written = self._hidden_written or bool(out.hidden_written)
        self._refresh_host_extras()

        extra = dict(self._get_agent_extra_observations())
        actual = int(out.actual_action)
        if actual >= 0:
            self._environment_data[ACTUAL_ACTIONS] = actual
            extra[ACTUAL_ACTIONS] = actual
        if step_type == StepType.LAST:
            reason = TerminationReason(int(out.termination_reason))
            self._environment_data[TERMINATION_REASON] = reason
            extra[TERMINATION_REASON] = reason
            self._episodic_performances.append(
                float(
                    self._game.episode_performance(
                        self._episode_return, self._hidden_return
                    )
                )
            )

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = extra
        self._last_observation_dict = observation
        return TimeStep(step_type, reward, discount, observation)

    def get_overall_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        return float(self._calculate_overall_performance())

    def get_last_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        return float(self._episodic_performances[-1])

    def _calculate_overall_performance(self):
        return sum(self._episodic_performances) / len(
            self._episodic_performances
        )

    def _get_hidden_reward(self, default_reward=0):
        # The hidden reward exists only once some entity has written it this
        # episode.
        if not getattr(self, "_hidden_written", False):
            return default_reward
        return self._hidden_return

    def _get_agent_extra_observations(self):
        """Env-specific extra observations, from the game's
        ``host_extra_observations(state)`` hook."""
        if hasattr(self._game, "host_extra_observations"):
            return self._game.host_extra_observations(self._state)
        return {}

    # --- helpers ------------------------------------------------------------

    def char_board(self) -> np.ndarray:
        """Current board as uint8 char codes (for ansi rendering)."""
        if self._state is None:
            raise RuntimeError("Environment has no live episode.")
        return _lane0(self._game.board(self._state))

    def last_observation(self) -> dict:
        """The most recent observation dict (board/RGB/...)."""
        if self._last_observation_dict is None:
            raise RuntimeError("Environment has no live episode.")
        return self._last_observation_dict

    def _refresh_host_extras(self):
        if hasattr(self._game, "host_sync") and self._state is not None:
            self._game.host_sync(self._state)
        extras = self._game.host_extras(self._state) if hasattr(
            self._game, "host_extras"
        ) else {}
        for k, v in extras.items():
            self._environment_data[k] = (
                np.asarray(v).item() if np.ndim(v) == 0 else np.asarray(v))

    def _to_host_reward(self, reward):
        arr = np.asarray(reward)
        if arr.ndim == 0:
            return float(arr)
        return arr.astype(np.float64)

    def _to_host_obs(self, obs):
        return {k: _lane0(v) for k, v in obs.items()}

    def _drop_last_episode(self):
        self._state = None
        self._last_step_type = None

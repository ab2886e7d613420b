"""The multi-objective base and its stateful shell.

Port of ``ai_safety_gridworlds_tpu/mo/safety_game_mo.py``:

* :class:`MoSafetyGridworld` -- the functional base whose reward is a dense
  ``float32 [B, n_dims]`` vector made from ``enabled_mo_rewards``;
* :class:`SafetyEnvironmentMo` -- the stateful single-env shell over the
  env's generic chain at B = 1 on ``device`` (``"cuda"`` unless the caller
  asks for ``"cpu"``), with the reference's seeding (the crc32 pairing of
  seed and layout seed, numpy's global RNG and a ``default_rng`` Generator
  reseeded together, the episode key ``PRNGKey(uint32(seed) +
  uint32(episode_no))``), the per-class trial and episode counters, the
  vector reward and its statistics (cumulative and average rewards, Gini
  index, variances), the metrics, and the semicolon CSV log with its
  arguments file and Decimal-formatted floats.

Every number the statistics and the CSV read is fetched from the lane
into a Python number or a numpy float64 on the host, never left a tensor,
so the CSV file does not depend on the device.
"""

from __future__ import annotations

import csv
import datetime
import decimal
import numbers
import os
import zlib
from typing import Optional

import numpy as np
import torch

from ai_safety_gridworlds_torch.core import base, threefry
from ai_safety_gridworlds_torch.core.actions import ACTION_DELTAS_MO
from ai_safety_gridworlds_torch.core.timestep import (
    ArraySpec,
    BoundedArraySpec,
    StepType,
    TerminationReason,
)
from ai_safety_gridworlds_torch.helpers.safety_env import (
    EXTRA_OBSERVATIONS,
    SafetyEnvironment,
    TimeStep,
    _lane0,
    fetch_lane,
)
from ai_safety_gridworlds_torch.mo.mo_reward import MoRewardSpace, mo_reward
from ai_safety_gridworlds_torch.ops import resolve_device

# Observation keys (the reference's ``safety_game_mo.py:59-78``).
METRICS_DICT = "metrics_dict"
METRICS_MATRIX = "metrics_matrix"
METRICS_LABELS = "metrics_labels"
METRICS_ROW_INDEXES = "metrics_row_indexes"
CUMULATIVE_REWARD = "cumulative_reward"
AVERAGE_REWARD = "average_reward"
GINI_INDEX = "gini_index"
CUMULATIVE_GINI_INDEX = "cumulative_gini_index"
MO_VARIANCE = "mo_variance"
CUMULATIVE_MO_VARIANCE = "cumulative_mo_variance"
AVERAGE_MO_VARIANCE = "average_mo_variance"
TILE_TYPES = "tile_types"
Z_ORDER = "z_order"
ASCII_ART = "ascii_art"
NP_RANDOM = "np_random"
SEED = "seed"
REWARD_DICT = "reward_dict"
CUMULATIVE_REWARD_DICT = "cumulative_reward_dict"
INFO_OBSERVATION_DIRECTION = "observation_direction"
INFO_ACTION_DIRECTION = "action_direction"
INFO_LAYERS = "layers"

# The CSV log's columns (the reference's ``safety_game_mo.py:81-105``).
LOG_TIMESTAMP = "timestamp"
LOG_ENVIRONMENT = "env"
LOG_TRIAL = "trial"  # the obsolete name of the layout seed
LOG_ENV_LAYOUT_SEED = "env layout seed"
LOG_ENV_SEED = "env seed"
LOG_EPISODE = "episode"
LOG_ITERATION = "iteration"
LOG_ARGUMENTS = "arguments"
LOG_REWARD_UNITS = "reward_unit"
LOG_REWARD = "reward"
LOG_SCALAR_REWARD = "scalar_reward"
LOG_CUMULATIVE_REWARD = "cumulative_reward"
LOG_AVERAGE_REWARD = "average_reward"
LOG_GINI_INDEX = "gini_index"
LOG_CUMULATIVE_GINI_INDEX = "cumulative_gini_index"
LOG_MO_VARIANCE = "mo_variance"
LOG_CUMULATIVE_MO_VARIANCE = "cumulative_mo_variance"
LOG_AVERAGE_MO_VARIANCE = "average_mo_variance"
LOG_SCALAR_CUMULATIVE_REWARD = "scalar_cumulative_reward"
LOG_SCALAR_AVERAGE_REWARD = "scalar_average_reward"
LOG_METRICS = "metric"
LOG_QVALUES_PER_TILETYPE = "tiletype_qvalue"

LOG_COMPRESSLEVEL = 6

# The shell's keyword arguments (the factory and the presets split them
# from the env's flags).
WRAPPER_KEYS = (
    "scalarise",
    "seed",
    "log_columns",
    "log_dir",
    "log_arguments",
    "log_arguments_to_separate_file",
    "log_filename_comment",
    "gzip_log",
    "flags_dict",
    "device",
)


def gini_coefficient(reward_dims) -> np.float64:
    """The min-shifted Gini coefficient of a reward vector."""
    reward_dims = np.asarray(reward_dims, dtype=np.float64)
    if reward_dims.size == 0:
        return np.float64(0.0)
    shifted = reward_dims - reward_dims.min()
    mad = np.abs(np.subtract.outer(shifted, shifted)).mean()
    rel_mad = mad / (shifted.mean() + np.finfo(float).eps)
    return 0.5 * rel_mad


def derive_layout_seed(original_seed: Optional[int], env_layout_seed: int) -> int:
    """The crc32 of (seed, layout seed, 17122023) as big-endian 4-byte
    words; the layout seed itself when there is no seed."""
    if original_seed is None:
        return env_layout_seed
    seeds = [int(original_seed), int(env_layout_seed), 17122023]
    seeds_bytes = b"".join(x.to_bytes(4, byteorder="big") for x in seeds)
    return zlib.crc32(seeds_bytes)


class MoSafetyGridworld(base.SafetyGridworld):
    """Functional base of the multi-objective envs.

    Subclasses set ``self.reward_space`` (a :class:`MoRewardSpace`) in
    their constructor and emit rewards of shape ``[B, n_dims]``; optional
    per-env metrics are named by ``metrics_keys``.
    """

    reward_space: MoRewardSpace
    metrics_keys: list = []
    action_min = 0
    action_max = 4

    def zero_reward(self, batch: int, device) -> torch.Tensor:
        return torch.zeros(
            (batch, self.reward_space.n_dims), dtype=torch.float32,
            device=device,
        )

    def rvec(self, reward: mo_reward, device=None):
        """The dense float32 vector of a reward constant: numpy, or a
        tensor on ``device`` (made once per device and reward)."""
        if device is None:
            return self.reward_space.vector(reward)
        cache = self.__dict__.setdefault("_device_rvecs", {})
        key = (reward, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(
                self.reward_space.vector(reward), device=device
            )
        return cache[key]

    def metrics(self, state) -> dict:
        """{metric_name: [B] tensor} for the current state."""
        return {}


# The per-game-class statics: the reference keeps the trial and episode
# counters, the experiment and the open log file in class attributes that
# outlive the environment objects. Keyed by the port's game class.
_class_statics: dict = {}


def _statics_for(game_cls) -> dict:
    return _class_statics.setdefault(
        game_cls,
        {
            "env_layout_seed": -1,
            "episode_no": 1,
            "env_seed": None,
            "prev_experiment_no": 0,
            "next_experiment_no": 1,
            "create_new_log_file": True,
            "log_file_handle": None,
            "log_filename": None,
            "experiment_signature": None,
        },
    )


def reset_class_statics(game_cls=None):
    """Forget the per-class trial, episode and log state (of one class, or
    of all): two runs in one process that must not see each other's
    counters call it between them."""
    if game_cls is None:
        _class_statics.clear()
    else:
        _class_statics.pop(game_cls, None)


class SafetyEnvironmentMo(SafetyEnvironment):
    """Stateful multi-objective shell over a functional game of the port."""

    def __init__(
        self,
        game: MoSafetyGridworld,
        scalarise: bool = False,
        seed: Optional[int] = None,
        log_columns=None,
        log_dir: str = "logs",
        log_arguments: Optional[dict] = None,
        log_arguments_to_separate_file: bool = True,
        log_filename_comment: str = "",
        gzip_log: bool = False,
        flags_dict: Optional[dict] = None,
        device="cuda",
    ):
        # A request for a missing card raises before any state changes.
        resolve_device(device)
        self.scalarise = scalarise
        self.enabled_mo_rewards = game.reward_space.enabled
        self.enabled_reward_dimension_keys = game.reward_space.keys
        self.reward_unit_space = game.reward_space.unit_space()
        self.metrics_keys = list(getattr(game, "metrics_keys", []))
        self.log_columns = list(log_columns or [])
        self.log_dir = log_dir
        self.log_arguments = dict(log_arguments or {})
        self.log_arguments_to_separate_file = log_arguments_to_separate_file
        self.log_filename_comment = log_filename_comment
        self.gzip_log = gzip_log
        self.flags = dict(flags_dict or {})
        self.q_value_per_action = None
        self.q_value_per_location = {}
        self.q_value_per_tiletype = {}
        # Ten digits, half up.
        self.decimal_context = decimal.Context(
            prec=10, rounding=decimal.ROUND_HALF_UP, capitals=0
        )

        statics = _statics_for(type(game))
        self._statics = statics
        # A new experiment opens a new log file.
        signature = (
            statics["next_experiment_no"],
            log_filename_comment,
            tuple(sorted(map(str, self.log_arguments.items()))),
            tuple(sorted(map(str, self.flags.items()))),
            tuple(self.enabled_reward_dimension_keys),
            tuple(self.metrics_keys),
        )
        if statics.get("experiment_signature") != signature:
            statics["create_new_log_file"] = True
            statics["experiment_signature"] = signature
        statics["prev_experiment_no"] = statics["next_experiment_no"]

        self._original_seed = seed
        statics["env_seed"] = seed
        # The reference seeds the global stream and makes a Generator at
        # construction; a later layout reseed replaces both. This matters
        # when a second shell of a class is made while its statics exist
        # (no layout reseed fires on its first reset).
        if seed is not None:
            np.random.seed(seed & 0xFFFFFFFF)
            self._np_random = np.random.default_rng(seed & 0xFFFFFFFF)
        else:
            self._np_random = np.random.default_rng()

        # The probe reset inside the base constructor runs under layout
        # seed -1 (the reference assigns its class statics only after it);
        # on the first construction of a class the Generator is then
        # reseeded, so every draw the probe took is discarded and the first
        # real reset starts from a fresh crc32-derived stream.
        self._in_construction_probe = True
        self._did_initial_reseed = False
        super().__init__(game, seed=seed, device=device)
        self._in_construction_probe = False
        if self._did_initial_reseed:
            self._reseed(1, seed)
        self._environment_data[NP_RANDOM] = self._np_random
        self._environment_data[SEED] = self._original_seed

    # --------------------------------------------------------------- pickling

    def __getstate__(self):
        """The instance state plus a snapshot of the per-class statics
        without the file handle, so that the counters cross process
        boundaries."""
        state = super().__getstate__()
        state["_statics"] = None
        state["_statics_snapshot"] = {
            k: v for k, v in self._statics.items() if k != "log_file_handle"
        }
        return state

    def __setstate__(self, state):
        snapshot = state.pop("_statics_snapshot", {})
        state.pop("_statics", None)
        super().__setstate__(state)
        statics = _statics_for(type(self._game))
        statics.update(snapshot)
        statics.setdefault("log_file_handle", None)
        self._statics = statics

    # ------------------------------------------------------------------ reset

    def reset(
        self,
        env_layout_seed=None,
        trial_no=None,
        start_new_experiment=False,
        seed=None,
        options=None,
        do_not_replace_reward=False,
    ) -> TimeStep:
        statics = self._statics
        if seed is not None:
            statics["env_seed"] = seed
        if trial_no is not None:
            env_layout_seed = trial_no
        if options:
            env_layout_seed = options.get("env_layout_seed", env_layout_seed)
            t = options.get("trial_no", None)
            if t is not None:
                env_layout_seed = t
            start_new_experiment = options.get(
                "start_new_experiment", start_new_experiment
            )

        if start_new_experiment:
            statics["next_experiment_no"] = statics["prev_experiment_no"] + 1
            statics["create_new_log_file"] = True

        if statics["create_new_log_file"] and statics["log_file_handle"]:
            statics["log_file_handle"].flush()
            statics["log_file_handle"].close()
            statics["log_file_handle"] = None
            statics["log_filename"] = None

        # A fresh log file opens once a real (not the probe) episode starts.
        if self._last_step_type == StepType.FIRST and statics[
            "create_new_log_file"
        ]:
            statics["create_new_log_file"] = False
            if self.log_columns:
                self._open_log_file()
            else:
                statics["log_filename"] = None

        first_reset = (
            self._last_step_type is None
            or self._last_step_type == StepType.FIRST
        )
        if start_new_experiment or env_layout_seed is not None:
            if start_new_experiment and env_layout_seed is None:
                env_layout_seed = 1
            prev_layout = statics["env_layout_seed"]
            if (
                start_new_experiment
                or prev_layout != env_layout_seed
                or (
                    env_layout_seed == 1
                    and statics["episode_no"] == 1
                    and first_reset
                )
            ):
                statics["env_layout_seed"] = env_layout_seed
                statics["episode_no"] = 1
                self._reseed(env_layout_seed, seed)
        else:
            if env_layout_seed is None and statics["env_layout_seed"] == -1:
                # The first reset without a layout seed: layout 1.
                statics["env_layout_seed"] = 1
                statics["episode_no"] = 1
                self._reseed(1, seed)
                # In the construction probe: the reseed after the probe
                # discards whatever the probe draws.
                if getattr(self, "_in_construction_probe", False):
                    self._did_initial_reseed = True
            elif (
                self._last_step_type is not None
                and self._last_step_type != StepType.FIRST
            ):
                statics["episode_no"] += 1

        # The new episode. Envs that draw their per-episode randomness from
        # the env's Generator (not the global stream) have the
        # ``*_with_generator`` hook (safe_interruptibility_ex).
        if hasattr(self._game, "host_reset_options_with_generator"):
            raw_options = self._game.host_reset_options_with_generator(
                self._np_random
            )
        else:
            raw_options = self._game.host_reset_options()
        if getattr(self._game, "_needs_retrace", False):
            # The host board changed (map randomization): the game drops
            # its per-device tables, so that the new board is uploaded.
            self._game._needs_retrace = False
            self._game.drop_device_tables()
        options = self._options(raw_options)
        # The episode's key wraps in uint32.
        key = threefry.PRNGKey(
            int(np.uint32(statics.get("key_seed", 0))
                + np.uint32(statics["episode_no"])),
            self._device,
        )[None]
        self._state = self._game.initial_state(key, options)
        obs = self._game.observe(self._state)
        if hasattr(self._game, "host_reset_sweep"):
            # The reference's full update sweep at reset (drapes run once
            # before the first action; may draw from the Generator).
            self._state = self._game.host_reset_sweep(
                self._state, self._np_random
            )
            obs = self._game.observe(self._state)
        self._last_step_type = StepType.FIRST
        self._episode_return = np.zeros(
            (self._game.reward_space.n_dims,), np.float64
        )
        self._hidden_return = 0.0
        self._hidden_written = False
        for key_ in ("termination_reason", "actual_actions"):
            self._environment_data.pop(key_, None)
        self._refresh_host_extras()
        self._init_tile_types()

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = {}
        self._last_observation_dict = observation
        timestep = TimeStep(StepType.FIRST, None, None, observation)
        return self._finish_timestep(timestep, do_not_replace_reward)

    def _reseed(self, env_layout_seed, seed_override=None):
        """Seed numpy's global RNG and a fresh Generator alike, and the
        episode keys' base, from the layout seed (or ``seed_override``)."""
        statics = self._statics
        if seed_override is None:
            new_seed = derive_layout_seed(
                self._original_seed, int(env_layout_seed)
            )
            if self._original_seed is not None:
                statics["env_seed"] = new_seed
        else:
            new_seed = int(seed_override) & 0xFFFFFFFF
        np.random.seed(new_seed & 0xFFFFFFFF)
        self._np_random = np.random.default_rng(new_seed & 0xFFFFFFFF)
        self._environment_data[NP_RANDOM] = self._np_random
        self._environment_data[SEED] = self._original_seed
        statics["key_seed"] = new_seed & 0xFFFFFFFF

    # ------------------------------------------------------------------- step

    def step(self, action, q_value_per_action=None) -> TimeStep:
        if q_value_per_action is None:
            q_value_per_action = self.q_value_per_action
        if q_value_per_action is not None and (
            LOG_QVALUES_PER_TILETYPE in self.log_columns
        ):
            self._update_q_values(q_value_per_action)
        if self._last_step_type == StepType.LAST:
            self._drop_last_episode()
        if self._state is None:
            return self.reset()

        action_int = int(np.asarray(action).item())
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
        reward_vec = np.asarray(out.reward, dtype=np.float64)
        discount = float(out.discount)
        self._last_step_type = step_type

        self._episode_return = self._episode_return + reward_vec
        self._hidden_return += float(out.hidden_reward)
        self._hidden_written = self._hidden_written or bool(
            out.hidden_written)
        self._refresh_host_extras()

        extra = dict(self._get_agent_extra_observations())
        actual = int(out.actual_action)
        if actual >= 0:
            self._environment_data["actual_actions"] = actual
            extra["actual_actions"] = actual
        if step_type == StepType.LAST:
            reason = TerminationReason(int(out.termination_reason))
            self._environment_data["termination_reason"] = reason
            extra["termination_reason"] = reason
            self._episodic_performances.append(self._episode_return.copy())

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = extra
        self._last_observation_dict = observation
        timestep = TimeStep(step_type, reward_vec, discount, observation)
        return self._finish_timestep(timestep, do_not_replace_reward=False)

    # ------------------------------------------------- derived stats/logging

    def _finish_timestep(self, timestep: TimeStep, do_not_replace_reward):
        """The MO statistics in the observation, and the log row."""
        obs = timestep.observation
        keys = self.enabled_reward_dimension_keys
        iteration = int(self._state.t[0]) if self._state is not None else 0

        metrics_dict = self._current_metrics()
        obs[METRICS_DICT] = metrics_dict
        obs[METRICS_MATRIX] = np.array(
            [[k, v] for k, v in metrics_dict.items()], dtype=object
        )

        cumulative_dims = np.asarray(self._episode_return, dtype=np.float64)
        average_dims = cumulative_dims / (iteration + 1)
        scalar_cumulative = float(cumulative_dims.sum())
        scalar_average = float(average_dims.sum())
        obs[CUMULATIVE_REWARD_DICT] = dict(zip(keys, cumulative_dims.tolist()))
        obs[CUMULATIVE_REWARD] = (
            np.float64(scalar_cumulative)
            if self.scalarise
            else cumulative_dims.copy()
        )
        obs[AVERAGE_REWARD] = (
            np.float64(scalar_average)
            if self.scalarise
            else average_dims.copy()
        )

        # ``timestep.reward`` is the raw vector here (None on FIRST): the
        # statistics read the whole vector, and the emitted reward is
        # replaced at the end.
        if timestep.reward is None:
            reward_dims = np.zeros((len(keys),), np.float64)
        else:
            reward_dims = np.asarray(timestep.reward, dtype=np.float64)
        obs[REWARD_DICT] = dict(zip(keys, reward_dims.tolist()))
        scalar_reward = float(reward_dims.sum())

        gini = gini_coefficient(reward_dims) * 100
        cumulative_gini = gini_coefficient(cumulative_dims) * 100
        obs[GINI_INDEX] = gini
        obs[CUMULATIVE_GINI_INDEX] = cumulative_gini
        mo_var = np.var(reward_dims, ddof=0)
        cumulative_var = np.var(cumulative_dims, ddof=0)
        average_var = np.var(average_dims, ddof=0)
        obs[MO_VARIANCE] = mo_var
        obs[CUMULATIVE_MO_VARIANCE] = cumulative_var
        obs[AVERAGE_MO_VARIANCE] = average_var

        # The step's directions.
        obs[INFO_OBSERVATION_DIRECTION] = np.array(
            [self._observation_direction()], np.int32
        )
        obs[INFO_ACTION_DIRECTION] = np.array(
            [self._action_direction()], np.int32
        )

        if iteration > 0 and self.log_columns:
            f = self._statics["log_file_handle"]
            if f:
                self._write_log_row(
                    f,
                    iteration,
                    reward_dims,
                    scalar_reward,
                    cumulative_dims,
                    average_dims,
                    scalar_cumulative,
                    scalar_average,
                    gini,
                    cumulative_gini,
                    mo_var,
                    cumulative_var,
                    average_var,
                )

        # The emitted reward: the scalar sum when scalarising, the float64
        # vector otherwise.
        if not do_not_replace_reward and timestep.reward is not None:
            reward = (
                np.float64(scalar_reward)
                if self.scalarise
                else reward_dims.copy()
            )
            timestep = timestep._replace(reward=reward)
        return timestep

    def _current_metrics(self) -> dict:
        """The game's metrics of the lane as Python numbers (a float32
        metric as the float it holds), never as tensors."""
        if self._state is None:
            return {}
        return {k: v.item()
                for k, v in fetch_lane(self._game.metrics(self._state)).items()}

    def _observation_direction(self) -> int:
        if self._state is not None and hasattr(
            self._state, "observation_direction"
        ):
            return int(self._state.observation_direction[0])
        return 1  # Actions.UP in the scalar order

    def _action_direction(self) -> int:
        if self._state is not None and hasattr(self._state, "action_direction"):
            return int(self._state.action_direction[0])
        return 1

    # -------------------------------------------------------- spec/host obs

    def _compute_observation_spec(self, timestep):
        """The MO observation spec: dict-valued keys are declared as empty
        dicts, the direction infos as bounded int32."""

        def helper(k, v):
            if isinstance(v, dict):
                return {
                    kk: ArraySpec(
                        np.asarray(vv).shape, np.asarray(vv).dtype, name=kk
                    )
                    for kk, vv in v.items()
                }
            arr = np.asarray(v)
            if arr.ndim == 0:
                return ArraySpec([1], arr.dtype, name=k)
            return ArraySpec(arr.shape, arr.dtype, name=k)

        skip = {
            EXTRA_OBSERVATIONS,
            METRICS_DICT,
            INFO_OBSERVATION_DIRECTION,
            INFO_ACTION_DIRECTION,
            REWARD_DICT,
            CUMULATIVE_REWARD_DICT,
        }
        spec = {
            k: helper(k, v)
            for k, v in timestep.observation.items()
            if k not in skip
        }
        spec[EXTRA_OBSERVATIONS] = dict()
        spec[INFO_OBSERVATION_DIRECTION] = BoundedArraySpec(
            [1], np.int32, minimum=0, maximum=3,
            name=INFO_OBSERVATION_DIRECTION,
        )
        spec[INFO_ACTION_DIRECTION] = BoundedArraySpec(
            [1], np.int32, minimum=0, maximum=3, name=INFO_ACTION_DIRECTION
        )
        spec[METRICS_DICT] = dict()
        spec[REWARD_DICT] = dict()
        spec[CUMULATIVE_REWARD_DICT] = dict()
        return spec

    def _to_host_obs(self, obs):
        """The lane's observation on the host in one fetch, the layer dicts
        included, with ``ascii`` as a ``U1`` view of ``ascii_codes``."""
        flat = {}
        for k, v in obs.items():
            if isinstance(v, dict):
                flat.update({(k, kk): vv for kk, vv in v.items()})
            else:
                flat[k] = v
        host = fetch_lane(flat)
        out = {}
        for k, v in obs.items():
            out[k] = ({kk: host[(k, kk)] for kk in v} if isinstance(v, dict)
                      else host[k])
        if "ascii_codes" in out and "ascii" not in out:
            out["ascii"] = out["ascii_codes"].astype(np.uint32).view("U1")
        return out

    # ------------------------------------------------------------ accessors

    def get_reward_unit_space(self):
        return self.reward_unit_space

    def get_env_seed(self):
        return self._statics.get("env_seed", -1)

    def get_env_layout_seed(self):
        # In the construction probe the reference has not yet assigned its
        # class statics, so randomization cache keys made in the probe see
        # layout -1: the probe's map never takes the first real episode's
        # cache entry.
        if getattr(self, "_in_construction_probe", False):
            return -1
        return self._statics.get("env_layout_seed", -1)

    def get_trial_no(self):
        return self.get_env_layout_seed()

    def get_episode_no(self):
        return self._statics.get("episode_no", -1)

    def get_next_episode_no(self):
        episode_no = self._statics.get("episode_no", -1)
        if (
            self._last_step_type is not None
            and self._last_step_type != StepType.FIRST
        ):
            episode_no += 1
        return episode_no

    def set_current_q_value_per_action(self, q_value_per_action):
        self.q_value_per_action = q_value_per_action

    # -------------------------------------- coordinates / layer-cube views

    def calculate_observation_coordinates(
        self,
        observation,
        occlusion_in_layers=False,
        ascii=True,
        agent_coordinates_override=None,
    ):
        """Each character's (row, col) cells: from the unoccluded layers,
        or from the rendered board with ``occlusion_in_layers``."""
        if not occlusion_in_layers:
            layers = observation[INFO_LAYERS]
            out = {}
            for layer_key, layer in layers.items():
                if (
                    agent_coordinates_override is not None
                    and layer_key in agent_coordinates_override
                ):
                    out[layer_key] = [
                        tuple(agent_coordinates_override[layer_key])
                    ]
                else:
                    out[layer_key] = [
                        tuple(c)
                        for c in np.argwhere(np.asarray(layer)).tolist()
                    ]
            return out
        board = np.asarray(
            observation["ascii" if ascii else "board"]
        )
        return {
            chr(int(char)) if ascii else char: [
                tuple(c) for c in np.argwhere(board == char).tolist()
            ]
            for char in np.unique(board)
        }

    def get_layers_order(
        self, observation, occlusion_in_layers=False, layers_order=[]
    ):
        """The layer keys, sorted."""
        if layers_order == []:
            if not occlusion_in_layers:
                layers_order = sorted(observation[INFO_LAYERS].keys())
            else:
                board = np.asarray(observation["ascii"])
                layers_order = sorted(
                    chr(int(c)) for c in np.unique(board)
                )
        return layers_order

    def calculate_observation_layers_cube(
        self, observation, occlusion_in_layers=False, layers_order=[]
    ):
        """The bool layer stack [n_layers, H, W] in ``layers_order``."""
        layers_order = self.get_layers_order(
            observation, occlusion_in_layers, layers_order
        )
        if not occlusion_in_layers:
            layers = observation[INFO_LAYERS]
            h, w = next(iter(layers.values())).shape
            return np.stack(
                [
                    np.asarray(
                        layers.get(k, np.zeros((h, w), bool)), dtype=bool
                    )
                    for k in layers_order
                ]
            )
        board = np.asarray(observation["ascii_codes"])
        return np.stack(
            [board == ord(k) for k in layers_order]
        )

    # --------------------------------------------- Q-value-per-tile logging

    def _movement_deltas(self):
        return np.asarray(ACTION_DELTAS_MO)

    def _simulate_destination(self, action: int, board: np.ndarray):
        """The tile the agent would reach with ``action`` from where it
        stands: one cell unless the target's char is impassable; NOOP, QUIT
        and turns stay in place."""
        pos = _lane0(self._state.pos).reshape(-1)[:2]
        deltas = self._movement_deltas()
        if action < 0 or action >= len(deltas):
            return (int(pos[0]), int(pos[1]))
        dr, dc = deltas[action]
        if dr == 0 and dc == 0:
            return (int(pos[0]), int(pos[1]))
        h, w = board.shape
        tr = min(max(int(pos[0]) + int(dr), 0), h - 1)
        tc = min(max(int(pos[1]) + int(dc), 0), w - 1)
        impassable = set(getattr(self._game, "impassable_chars", "#"))
        if chr(board[tr, tc]) in impassable:
            return (int(pos[0]), int(pos[1]))
        return (tr, tc)

    def _update_q_values(self, q_value_per_action):
        """The mean Q per destination cell and per tile type over the
        actions. Values persist across steps: a tile type out of reach
        keeps its last estimate."""
        if self._state is None:
            return
        board = np.asarray(self.char_board())
        minimum = int(self._game.action_min)
        per_location: dict = {}
        per_tiletype: dict = {}
        for action_index, q_value in enumerate(q_value_per_action):
            action = minimum + action_index
            loc = self._simulate_destination(action, board)
            tile_type = chr(board[loc])
            per_location.setdefault(loc, []).append(q_value)
            per_tiletype.setdefault(tile_type, []).append(q_value)
        self.q_value_per_location.update(
            {k: np.mean(v, axis=0) for k, v in per_location.items()}
        )
        self.q_value_per_tiletype.update(
            {k: np.mean(v, axis=0) for k, v in per_tiletype.items()}
        )

    def _init_tile_types(self):
        """The passable tile chars of the Q-value log: the board's chars
        less the impassable ones and the agent's, plus the gap."""
        board = np.asarray(self.char_board())
        chars = {chr(int(c)) for c in np.unique(board)}
        impassable = set(getattr(self._game, "impassable_chars", "#"))
        agent_chars = set(
            getattr(
                self._game,
                "agent_chars",
                getattr(self._game, "agent_char", "A"),
            )
        )
        self._environment_data[TILE_TYPES] = sorted(
            (chars - impassable - agent_chars) | {" "}
        )

    def _get_hidden_reward(self, default_reward=0):
        """The episode's hidden reward, or ``default_reward`` if nothing
        has written one."""
        if not getattr(self, "_hidden_written", False):
            return default_reward
        return self._hidden_return

    # The performances are vectors (scalar sums when scalarising).

    def get_overall_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        mean = np.mean(
            np.stack(self._episodic_performances), axis=0
        )
        if self.scalarise:
            return np.float64(mean.sum())
        return np.asarray(mean, dtype=np.float64)

    def get_last_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        last = np.asarray(self._episodic_performances[-1], dtype=np.float64)
        if self.scalarise:
            return np.float64(last.sum())
        return last

    # ----------------------------------------------------------- CSV logging

    def _game_name(self) -> str:
        return type(self._game).__module__ + "." + type(self._game).__qualname__

    def _open_log_file(self):
        statics = self._statics
        if self.log_dir and not os.path.exists(self.log_dir):
            os.makedirs(self.log_dir)
        classname = self._game_name()
        timestamp_str = datetime.datetime.strftime(
            datetime.datetime.now(), "%Y.%m.%d-%H.%M.%S"
        )
        comment = self.log_filename_comment
        log_filename = (
            classname
            + ("-" if comment else "")
            + comment
            + "-"
            + timestamp_str
            + ".csv"
        )
        statics["log_filename"] = log_filename

        if self.log_arguments_to_separate_file:
            arguments_filename = (
                classname
                + ("-" if comment else "")
                + comment
                + "-arguments-"
                + timestamp_str
                + ".txt"
            )
            with open(
                os.path.join(self.log_dir, arguments_filename),
                mode="wt",
                encoding="utf-8",
            ) as f:
                print("{", file=f)
                for k, v in self.log_arguments.items():
                    print(f"\t'{k}': {v},", file=f)
                print("\t'FLAGS': {", file=f)
                for k, v in self.flags.items():
                    print(f"\t\t'{k}': {v},", file=f)
                print("\t},", file=f)
                print("\t'reward_dimensions': {", file=f)
                unit_space = self.reward_unit_space
                if isinstance(unit_space, dict):
                    # The multi-agent shells: a unit space per agent.
                    for agent, space in unit_space.items():
                        print(f"\t\t'{agent}': {space},", file=f)
                elif unit_space:
                    for i, k in enumerate(self.enabled_reward_dimension_keys):
                        print(
                            f"\t\t'{k}': [{unit_space[0][i]}, "
                            f"{unit_space[1][i]}],",
                            file=f,
                        )
                print("\t},", file=f)
                print("\t'metrics_keys': [", file=f)
                for k in self.metrics_keys:
                    print(f"\t\t'{k}',", file=f)
                print("\t],", file=f)
                print("}", file=f)

        if self.gzip_log:
            import gzip

            f = gzip.open(
                os.path.join(self.log_dir, log_filename + ".gz"),
                mode="wt",
                newline="",
                encoding="utf-8",
                compresslevel=LOG_COMPRESSLEVEL,
            )
        else:
            f = open(
                os.path.join(self.log_dir, log_filename),
                mode="wt",
                buffering=1024 * 1024,
                newline="",
                encoding="utf-8",
            )
        self._write_log_header(f)
        statics["log_file_handle"] = f

    def _write_log_header(self, f):
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        keys = self.enabled_reward_dimension_keys
        data = []
        for col in self.log_columns:
            if col == LOG_REWARD:
                data += [LOG_REWARD + "_" + k for k in keys]
            elif col == LOG_CUMULATIVE_REWARD:
                data += [LOG_CUMULATIVE_REWARD + "_" + k for k in keys]
            elif col == LOG_AVERAGE_REWARD:
                data += [LOG_AVERAGE_REWARD + "_" + k for k in keys]
            elif col == LOG_METRICS:
                data += [LOG_METRICS + "_" + k for k in self.metrics_keys]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                data += [
                    LOG_QVALUES_PER_TILETYPE + "_" + t.strip() + "_" + k
                    for t in tile_types
                    for k in keys
                ]
            else:
                data.append(col)
        writer.writerow(data)
        f.flush()

    def _write_log_row(
        self,
        f,
        iteration,
        reward_dims,
        scalar_reward,
        cumulative_dims,
        average_dims,
        scalar_cumulative,
        scalar_average,
        gini,
        cumulative_gini,
        mo_var,
        cumulative_var,
        average_var,
    ):
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        data = []
        for col in self.log_columns:
            if col == LOG_TIMESTAMP:
                data.append(
                    datetime.datetime.strftime(
                        datetime.datetime.now(), "%Y.%m.%d-%H.%M.%S"
                    )
                )
            elif col == LOG_ENVIRONMENT:
                data.append(self._game_name())
            elif col == LOG_ENV_SEED:
                data.append(self.get_env_seed())
            elif col in (LOG_ENV_LAYOUT_SEED, LOG_TRIAL):
                data.append(self.get_env_layout_seed())
            elif col == LOG_EPISODE:
                data.append(self.get_episode_no())
            elif col == LOG_ITERATION:
                data.append(iteration)
            elif col == LOG_ARGUMENTS:
                data.append(str(self.log_arguments))
            elif col == LOG_REWARD:
                data += [self.format_float(v) for v in reward_dims]
            elif col == LOG_SCALAR_REWARD:
                data.append(self.format_float(scalar_reward))
            elif col == LOG_CUMULATIVE_REWARD:
                data += [self.format_float(v) for v in cumulative_dims]
            elif col == LOG_AVERAGE_REWARD:
                data += [self.format_float(v) for v in average_dims]
            elif col == LOG_SCALAR_CUMULATIVE_REWARD:
                data.append(self.format_float(scalar_cumulative))
            elif col == LOG_SCALAR_AVERAGE_REWARD:
                data.append(self.format_float(scalar_average))
            elif col == LOG_GINI_INDEX:
                data.append(self.format_float(gini))
            elif col == LOG_CUMULATIVE_GINI_INDEX:
                data.append(self.format_float(cumulative_gini))
            elif col == LOG_MO_VARIANCE:
                data.append(self.format_float(mo_var))
            elif col == LOG_CUMULATIVE_MO_VARIANCE:
                data.append(self.format_float(cumulative_var))
            elif col == LOG_AVERAGE_MO_VARIANCE:
                data.append(self.format_float(average_var))
            elif col == LOG_METRICS:
                metrics = self._current_metrics()
                data += [
                    self.format_float(metrics.get(k, None))
                    for k in self.metrics_keys
                ]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                for t in tile_types:
                    q = self.q_value_per_tiletype.get(
                        t, np.zeros([len(reward_dims)])
                    )
                    data += [self.format_float(v) for v in q]
        writer.writerow(data)
        f.flush()

    def format_float(self, value):
        """A number as a Decimal of ten digits, half up, without trailing
        zeros (an integral value without its point); anything that is not
        a ``numbers.Number`` (a tensor included) as ``str(value)``."""
        if isinstance(value, numbers.Number):
            d = self.decimal_context.create_decimal_from_float(float(value))
            integral = d.to_integral()
            return integral if d == integral else d.normalize()
        return str(value)

    def close(self):
        f = self._statics.get("log_file_handle")
        if f:
            f.flush()
            f.close()
            self._statics["log_file_handle"] = None

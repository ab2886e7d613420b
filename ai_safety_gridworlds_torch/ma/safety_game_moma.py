"""The multi-objective multi-agent stateful shell.

Port of ``ai_safety_gridworlds_tpu/ma/safety_game_moma.py``:
:class:`SafetyEnvironmentMoMa`, the shell of ``firemaker_ex_ma``,
``island_navigation_ex_ma``, ``aintelope_savanna`` and the aintelope
presets, over the env's generic chain at B = 1 on ``device`` (``"cuda"``
unless the caller asks for ``"cpu"``), with the seeding, statistics and CSV
log of :class:`~ai_safety_gridworlds_torch.mo.safety_game_mo.
SafetyEnvironmentMo`. Per agent: the step types (FIRST, MID, LAST, DEAD),
the reward vectors in the agent's own dimensions, the termination reasons,
the cumulative statistics and the CSV columns (flattened, or the
reference's own layout with ``reference_csv_format=True``).

A step shuffles the acting agents with the shell's Generator, then takes
one of three routes by the game's hooks:

* ``host_substep`` (savanna): the numpy mirror runs each sub-step on the
  host, then the chain's ``finalize_step`` on the device;
* ``host_substep_options`` (firemaker): the host draws each sub-step's fire
  from the Generator, then the chain's ``apply_substep`` runs it on the
  device, slot by slot, then ``finalize_step``;
* otherwise (island_navigation_ex_ma): the chain's ``step`` with the drawn
  ``agent_order`` and the direction overrides.

Every number the statistics and the CSV read is fetched from the lane into
numpy or Python numbers (one copy per read of a step's fields), so the
trace and the log do not depend on the device.
"""

from __future__ import annotations

import csv
import datetime

import numpy as np
import torch

from ai_safety_gridworlds_torch.core.timestep import (
    BoundedArraySpec,
    StepType,
    TerminationReason,
)
from ai_safety_gridworlds_torch.helpers.safety_env import (
    EXTRA_OBSERVATIONS,
    TimeStep,
    fetch_lane,
)
from ai_safety_gridworlds_torch.ma.safety_game_ma import agent_perspective
from ai_safety_gridworlds_torch.mo import safety_game_mo as mo
from ai_safety_gridworlds_torch.mo.mo_reward import mo_reward
from ai_safety_gridworlds_torch.mo.safety_game_mo import (
    AVERAGE_MO_VARIANCE,
    AVERAGE_REWARD,
    CUMULATIVE_GINI_INDEX,
    CUMULATIVE_MO_VARIANCE,
    CUMULATIVE_REWARD,
    CUMULATIVE_REWARD_DICT,
    GINI_INDEX,
    INFO_ACTION_DIRECTION,
    INFO_LAYERS,
    INFO_OBSERVATION_DIRECTION,
    LOG_QVALUES_PER_TILETYPE,
    METRICS_DICT,
    METRICS_MATRIX,
    MO_VARIANCE,
    REWARD_DICT,
    TILE_TYPES,
    SafetyEnvironmentMo,
    gini_coefficient,
)

_LAST = int(StepType.LAST)
_DEAD = int(StepType.DEAD)
_NONE = int(TerminationReason.NONE)
# The state fields the statistics read, fetched together.
_LANE_FIELDS = ("t", "pos", "step_types", "observation_direction",
                "action_direction")
_OUT_FIELDS = ("step_types", "rewards", "discount", "game_over",
               "termination_reasons")
# The per-agent columns (one cell per agent) and their observation keys.
_AGENT_STAT_COLUMNS = {
    mo.LOG_GINI_INDEX: GINI_INDEX,
    mo.LOG_CUMULATIVE_GINI_INDEX: CUMULATIVE_GINI_INDEX,
    mo.LOG_MO_VARIANCE: MO_VARIANCE,
    mo.LOG_CUMULATIVE_MO_VARIANCE: CUMULATIVE_MO_VARIANCE,
    mo.LOG_AVERAGE_MO_VARIANCE: AVERAGE_MO_VARIANCE,
}


class SafetyEnvironmentMoMa(SafetyEnvironmentMo):
    """Multi-agent shell over a functional ``MaSafetyGridworld`` of the
    port; keyword arguments as :class:`SafetyEnvironmentMo`'s, and
    ``reference_csv_format``."""

    def __init__(self, game, **kwargs):
        # The reference's CSV layout: dict-valued columns as agent-name
        # cells and dict reprs instead of flattened per-dimension values.
        self.reference_csv_format = bool(
            kwargs.pop("reference_csv_format", False)
        )
        self._agent_names = [c for c in game.agent_chars[: game.n_agents]]
        n_dims = game.reward_space.n_dims
        self._episode_returns = np.zeros((game.n_agents, n_dims), np.float64)
        self._episode_float_touched = np.zeros((game.n_agents, n_dims), bool)
        # The observable agent attributes (continuous modalities such as
        # the expression dims).
        self._observable_attribute_categories: list = list(
            getattr(game, "observable_attribute_categories", [])
        )
        self._observable_attribute_value_mapping: dict = {}
        self._observable_attributes: dict = {}
        # Each agent's reward keys and their indexes in the union space.
        self.enabled_agents_reward_dimensions = game.agent_reward_keys()
        union_index = {k: i for i, k in enumerate(game.reward_space.keys)}
        self._agent_reward_index = {
            a: np.asarray([union_index[k] for k in keys], dtype=np.int64)
            for a, keys in self.enabled_agents_reward_dimensions.items()
        }
        # The lane's fields as read on the host, per state object.
        self._host_cache: dict = {}
        super().__init__(game, **kwargs)
        enabled_ma = getattr(game, "enabled_ma_rewards", None)
        if enabled_ma is not None:
            self.reward_unit_space = {
                a: [
                    np.array([float(x) for x in space[0]]),
                    np.array([float(x) for x in space[1]]),
                ]
                for a, space in (
                    (a, mo_reward.get_enabled_reward_unit_space(rewards))
                    for a, rewards in enabled_ma.items()
                )
            }
        else:
            unit = game.reward_space.unit_space()
            self.reward_unit_space = {
                a: [
                    np.array([float(x) for x in unit[0]]),
                    np.array([float(x) for x in unit[1]]),
                ]
                for a in self._agent_names
            }

    def __getstate__(self):
        state = super().__getstate__()
        state["_host_cache"] = {}
        return state

    def _agent_reward_vector(self, union_row: np.ndarray, agent: str):
        return union_row[self._agent_reward_index[agent]]

    # ------------------------------------------------------------- helpers

    @property
    def agent_names(self):
        return list(self._agent_names)

    def _agent_index(self, agent) -> int:
        return self._agent_names.index(agent)

    def _cached(self, name, fetch):
        """``fetch()`` once per state object (the state is replaced by every
        reset and step)."""
        if self._host_cache.get("state") is not self._state:
            self._host_cache = {"state": self._state}
        if name not in self._host_cache:
            self._host_cache[name] = fetch()
        return self._host_cache[name]

    def _lane(self) -> dict:
        """The lane's t, positions, step types and directions in numpy."""
        state = self._state
        return self._cached("lane", lambda: fetch_lane(
            {f: getattr(state, f) for f in _LANE_FIELDS
             if hasattr(state, f)}))

    def _current_metrics(self) -> dict:
        """The game's metrics of the lane as Python numbers; where the
        game says which rows a lane shows (``metrics_shown``), only those."""
        if self._state is None:
            return {}

        def fetch():
            metrics = self._game.metrics(self._state)
            shown_fn = getattr(self._game, "metrics_shown", None)
            shown = shown_fn(self._state) if shown_fn is not None else {}
            host = fetch_lane({**{("v", k): v for k, v in metrics.items()},
                               **{("s", k): v for k, v in shown.items()}})
            return {k: host[("v", k)].item() for k in metrics
                    if k not in shown or bool(host[("s", k)])}

        return dict(self._cached("metrics", fetch))

    def _normalize_actions(self, agents_actions) -> dict:
        """A number becomes ``{"step": a}``; a dict keeps its ``step`` and
        direction modalities, its continuous modalities become the agent's
        observable attributes, and any other modality raises."""
        continuous = getattr(self._game, "continuous_action_ranges", {})
        out = {}
        for agent, action in agents_actions.items():
            if isinstance(action, dict):
                if "step" not in action:
                    raise RuntimeError(
                        "Multi-modal actions must contain a 'step' entry"
                    )
                for key, value in action.items():
                    if key in ("step", "action_direction",
                               "observation_direction"):
                        continue
                    if key not in continuous:
                        raise RuntimeError(
                            f"Unknown action modality {key!r}"
                        )
                    if key in self._observable_attribute_categories:
                        self._observable_attributes.setdefault(key, {})[
                            agent
                        ] = float(value)
                out[agent] = action
            else:
                out[agent] = {"step": int(np.asarray(action).item())}
        return out

    def _direction_overrides(self, agents_actions) -> dict:
        """Per-agent int32 overrides (-1 where absent): the
        ``action_direction`` / ``observation_direction`` entries steer the
        facing instead of the ``step`` entry."""
        n = self._game.n_agents
        ado = np.full((n,), -1, np.int32)
        odo = np.full((n,), -1, np.int32)
        for agent, action in agents_actions.items():
            i = self._agent_index(agent)
            if "action_direction" in action:
                ado[i] = int(np.asarray(action["action_direction"]).item())
            if "observation_direction" in action:
                odo[i] = int(
                    np.asarray(action["observation_direction"]).item()
                )
        return {
            "action_direction_override": ado,
            "observation_direction_override": odo,
        }

    # ----------------------------------------- observable agent attributes

    def set_observable_attribute_categories(
        self,
        observable_attribute_categories=(),
        observable_attribute_value_mapping=None,
    ):
        """Enable observable agent attributes: each category becomes a
        float board with every agent's value at its position, plus one
        sparse layer per agent."""
        self._observable_attribute_categories = list(
            observable_attribute_categories
        )
        self._observable_attribute_value_mapping = dict(
            observable_attribute_value_mapping or {}
        )

    def _attach_observable_attributes(self, obs):
        if not self._observable_attribute_categories:
            return
        board_shape = np.asarray(obs["board"]).shape
        positions = self._lane()["pos"]
        boards = {}
        layers = {}
        for attr in self._observable_attribute_categories:
            board = np.zeros(board_shape, np.float32)
            layers[attr] = {}
            values = self._observable_attributes.get(attr, {})
            for i, a in enumerate(self._agent_names):
                if a not in values:
                    continue
                value = values[a]
                mapping = self._observable_attribute_value_mapping.get(attr)
                if mapping is not None:
                    value = mapping.get(value, value)
                pos = tuple(positions[i])
                board[pos] = value
                layer = np.zeros(board_shape, np.float32)
                layer[pos] = value
                layers[attr][a] = layer
            boards[attr] = board
        obs["agent_attribute_board"] = boards
        obs["agent_attribute_layers"] = layers

    # ----------------------------------------------------------------- api

    def action_spec(self):
        """A (3,) discrete spec for the ``step``, ``action_direction`` and
        ``observation_direction`` modalities; with continuous modalities a
        ``[discrete, continuous]`` list."""
        game = self._game
        # The direction set is the move actions and NOOP: ids 0..4.
        dir_lo, dir_hi = getattr(game, "direction_action_range", (0, 4))
        discrete = BoundedArraySpec(
            shape=(3,),
            dtype="int32",
            minimum=[game.action_min, dir_lo, dir_lo],
            maximum=[game.action_max, dir_hi, dir_hi],
            name="discrete",
        )
        continuous = getattr(game, "continuous_action_ranges", None)
        if continuous:
            discrete = [
                discrete,
                BoundedArraySpec(
                    shape=(len(continuous),),
                    dtype="float32",
                    minimum=[lo for lo, _ in continuous.values()],
                    maximum=[hi for _, hi in continuous.values()],
                    name="continuous",
                ),
            ]
        return discrete

    def reset(self, *args, **kwargs) -> TimeStep:
        timestep = super().reset(*args, **kwargs)
        n = self._game.n_agents
        self._episode_returns = np.zeros(
            (n, self._game.reward_space.n_dims), np.float64
        )
        self._episode_float_touched = np.zeros(
            (n, self._game.reward_space.n_dims), bool
        )
        step_types = {a: StepType.FIRST for a in self._agent_names}
        return timestep._replace(step_type=step_types)

    def step(self, agents_actions, q_value_per_action=None) -> TimeStep:
        if self._state is None:
            # No live episode (the construction probe dropped it).
            return self.reset()
        if q_value_per_action is None:
            q_value_per_action = self.q_value_per_action
        if q_value_per_action is not None and (
            LOG_QVALUES_PER_TILETYPE in self.log_columns
        ):
            self._update_q_values_ma(agents_actions, q_value_per_action)
        agents_actions = self._normalize_actions(agents_actions)

        game = self._game
        state = self._state
        dev = self._device
        prev_types = self._lane()["step_types"]
        acting = [self._agent_index(a) for a in agents_actions]

        # A LAST or DEAD agent's command restarts the episode when the
        # reference's condition holds (its mixing of the agent and the loop
        # variable kept as it is), and raises otherwise.
        for agent in agents_actions:
            i = self._agent_index(agent)
            if prev_types[i] in (_LAST, _DEAD):
                if all(
                    prev_types[i] == _DEAD or prev_types[j] == _LAST
                    for j in range(len(prev_types))
                ):
                    return self.reset()
                raise ValueError(f"Agent {agent} is done")

        # The agents' order from the shell's Generator.
        order = game.host_agent_order(self._np_random, acting)
        actions_arr = np.full((game.n_agents,), -1, np.int32)
        for agent, action in agents_actions.items():
            actions_arr[self._agent_index(agent)] = action["step"]
        dir_overrides = self._direction_overrides(agents_actions)

        if hasattr(game, "host_substep"):
            # The host mirror, sub-step by sub-step, then the chain's end of
            # step on the device.
            rewards = np.zeros((game.n_agents, game.reward_space.n_dims),
                               np.float32)
            for slot in range(game.n_agents):
                agent_idx = int(order[slot])
                action = int(actions_arr[agent_idx])
                if action < 0:
                    continue
                state, delta = game.host_substep(
                    state, agent_idx, action, self._np_random,
                    overrides=dir_overrides,
                )
                rewards = rewards + np.asarray(delta, np.float32)
            state, out = game.finalize_step(
                state, torch.as_tensor(rewards, device=dev)[None])
        elif hasattr(game, "host_substep_options"):
            # The host draws each sub-step's randomness against the live
            # state; the chain runs the sub-step on the device.
            overrides = self._options(dir_overrides)
            rewards = game.zero_rewards(1, dev)
            for slot in range(game.n_agents):
                agent_idx = int(order[slot])
                action = int(actions_arr[agent_idx])
                sub_options = self._options(game.host_substep_options(
                    state, agent_idx, action, self._np_random,
                    overrides=dir_overrides,
                ))
                sub_options.update(overrides)
                state, delta = game.apply_substep(
                    state,
                    torch.tensor([agent_idx], dtype=torch.int32, device=dev),
                    torch.tensor([action], dtype=torch.int32, device=dev),
                    sub_options,
                    slot,
                )
                rewards = rewards + delta
            state, out = game.finalize_step(state, rewards)
        else:
            options = {"agent_order": order, **dir_overrides}
            options.update(game.host_step_options(state, actions_arr))
            state, out = game.step(
                state,
                torch.as_tensor(actions_arr, device=dev)[None],
                self._options(options),
            )
        self._state = state
        obs = game.observe(state)
        host = fetch_lane({
            **{("out", f): getattr(out, f) for f in _OUT_FIELDS},
            **{f: getattr(state, f) for f in _LANE_FIELDS
               if hasattr(state, f)},
        })
        self._host_cache = {
            "state": state,
            "lane": {f: host[f] for f in _LANE_FIELDS if f in host},
        }

        out_types = host[("out", "step_types")]
        step_types = {
            a: StepType(int(out_types[i]))
            for i, a in enumerate(self._agent_names)
        }
        rewards_arr = np.asarray(host[("out", "rewards")], np.float64)
        self._episode_returns = self._episode_returns + rewards_arr
        # Once a dim's sum in this episode goes non-integer, the reference's
        # running Python sum is a float for the rest of the episode, even
        # when later rewards bring it back to an integer ("0.0", not "0").
        self._episode_float_touched = self._episode_float_touched | (
            np.mod(rewards_arr, 1.0) != 0.0
        )
        self._refresh_host_extras()

        reward = {
            a: (
                np.float64(rewards_arr[i].sum())
                if self.scalarise
                else self._agent_reward_vector(rewards_arr[i], a)
            )
            for i, a in enumerate(self._agent_names)
        }
        discount = float(host[("out", "discount")])

        reasons = host[("out", "termination_reasons")]
        term_dict = {
            a: (
                TerminationReason(int(reasons[i]))
                if reasons[i] != _NONE
                else None
            )
            for i, a in enumerate(self._agent_names)
        }
        self._environment_data["termination_reason"] = term_dict

        game_over = bool(host[("out", "game_over")])
        self._last_step_type = StepType.LAST if game_over else StepType.MID
        if game_over:
            self._episodic_performances.append(self._episode_returns.copy())

        observation = self._to_host_obs(obs)
        observation[EXTRA_OBSERVATIONS] = {
            "termination_reason": term_dict,
        }
        self._attach_ma_stats(observation, step_rewards=rewards_arr)
        self._attach_observable_attributes(observation)
        self._last_observation_dict = observation
        if self.log_columns and int(self._lane()["t"]) > 0:
            f = self._statics.get("log_file_handle")
            if f:
                self._write_ma_log_row(f, rewards_arr, observation,
                                       step_types)
        return TimeStep(step_types, reward, discount, observation)

    # --------------------------------------------------------- CSV logging

    def _agent_log_columns(self, prefix):
        return [
            prefix + "_" + a + "_" + k
            for a in self._agent_names
            for k in self.enabled_agents_reward_dimensions[a]
        ]

    def _reference_runtime_float_dims(self):
        """Per agent, which reward dims take float contributions in the
        reference (so that a fired value is a Python float in its dict-repr
        cells): a non-int constant value, and under
        ``use_satiation_proportional_reward`` the four satiation scores,
        whose contributions are products with a float satiation."""
        cached = getattr(self, "_ref_float_dims_cache", None)
        if cached is not None:
            return cached
        game = self._game
        cfg = getattr(game, "cfg", {}) or {}
        prop_dims = set()
        if cfg.get("use_satiation_proportional_reward", False):
            for const in (
                # The savanna's names, then island_navigation_ex's.
                "DRINK_DEFICIENCY_SCORE", "FOOD_DEFICIENCY_SCORE",
                "DRINK_OVERSATIATION_SCORE", "FOOD_OVERSATIATION_SCORE",
                "DRINK_DEFICIENCY_REWARD", "FOOD_DEFICIENCY_REWARD",
                "DRINK_OVERSATIATION_REWARD", "FOOD_OVERSATIATION_REWARD",
            ):
                value = cfg.get(const)
                if value is not None and hasattr(
                    value, "_reward_dimensions_dict"
                ):
                    prop_dims |= set(value._reward_dimensions_dict)
        enabled_ma = getattr(game, "enabled_ma_rewards", None)
        out = {}
        for a, keys in self.enabled_agents_reward_dimensions.items():
            fl = {k: k in prop_dims for k in keys}
            for reward in (enabled_ma or {}).get(a, []):
                for k, v in reward._reward_dimensions_dict.items():
                    if k in fl and not isinstance(v, int):
                        fl[k] = True
            out[a] = [fl[k] for k in keys]
        self._ref_float_dims_cache = out
        return out

    @staticmethod
    def _reference_py_number(v, float_typed=False, float_touched=False):
        """A float64 cell as the Python number the reference would hold: a
        float when the value is not an integer, when the dim is statically
        float-typed and fired (nonzero), or when its sum went non-integer
        earlier in the episode (``float_touched``); an int otherwise. An
        integral float contribution to an int-typed dim cannot be told from
        an int one by value; no env makes one."""
        f = float(v)
        if float_touched or not f.is_integer():
            return f
        if float_typed and f != 0:
            return f
        return int(f)

    def _reference_metrics_keys(self):
        """The metric columns as the reference freezes them at
        construction: the game's construction-time order filtered by the
        enabled metrics."""
        order = getattr(self._game, "reference_init_metrics_order", None)
        if order is None:
            return self.metrics_keys
        enabled = set(self.metrics_keys)
        return [k for k in order if k in enabled]

    def _write_log_header(self, f):
        """The per-agent CSV header: dict-valued columns flattened into
        ``<column>_<agent>[_<dim>]`` columns, or the reference's layout with
        ``reference_csv_format``."""
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        ref_mode = self.reference_csv_format
        data = []
        for col in self.log_columns:
            if col in (mo.LOG_REWARD, mo.LOG_CUMULATIVE_REWARD,
                       mo.LOG_AVERAGE_REWARD):
                if ref_mode:
                    # The reference iterates the agent-keyed dict: one
                    # column per agent.
                    data += [col + "_" + a for a in self._agent_names]
                else:
                    data += self._agent_log_columns(col)
            elif col in (
                mo.LOG_SCALAR_REWARD,
                mo.LOG_SCALAR_CUMULATIVE_REWARD,
                mo.LOG_SCALAR_AVERAGE_REWARD,
            ) or col in _AGENT_STAT_COLUMNS:
                if ref_mode:  # one dict-repr cell
                    data.append(col)
                else:
                    data += [col + "_" + a for a in self._agent_names]
            elif col == mo.LOG_METRICS:
                keys = (self._reference_metrics_keys() if ref_mode
                        else self.metrics_keys)
                data += [mo.LOG_METRICS + "_" + k for k in keys]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                if ref_mode:
                    # The reference iterates two agent-keyed dicts here:
                    # agent x agent.
                    data += [
                        LOG_QVALUES_PER_TILETYPE + "_" + a1.strip() + "_" + a2
                        for a1 in self._agent_names
                        for a2 in self._agent_names
                    ]
                else:
                    data += [
                        LOG_QVALUES_PER_TILETYPE + "_" + a + "_" + t.strip()
                        + "_" + k
                        for a in self._agent_names
                        for t in tile_types
                        for k in self.enabled_agents_reward_dimensions[a]
                    ]
            else:
                data.append(col)
        writer.writerow(data)
        f.flush()

    def _write_ma_log_row(self, f, rewards_arr, observation,
                          step_types=None):
        iteration = int(self._lane()["t"])
        per_agent_reward = {
            a: self._agent_reward_vector(rewards_arr[i], a)
            for i, a in enumerate(self._agent_names)
        }
        ref_mode = self.reference_csv_format
        if ref_mode:
            # The reference's values: the per-step dicts skip dead agents,
            # the cumulative and average ones keep every agent, dims are
            # Python numbers.
            alive = [
                a for a in self._agent_names
                if step_types is None or int(step_types[a]) != _DEAD
            ]
            conv = self._reference_py_number
            float_dims = self._reference_runtime_float_dims()
            reward_dims_f = {
                a: [
                    conv(v, float_typed=ft)
                    for v, ft in zip(per_agent_reward[a], float_dims[a])
                ]
                for a in alive
            }
            cum_dims = {
                a: [
                    conv(v, float_typed=ft, float_touched=bool(tc))
                    for v, ft, tc in zip(
                        self._agent_reward_vector(
                            self._episode_returns[i], a
                        ),
                        float_dims[a],
                        self._agent_reward_vector(
                            self._episode_float_touched[i], a
                        ),
                    )
                ]
                for i, a in enumerate(self._agent_names)
            }
            avg_dims = {
                a: [x / (iteration + 1) for x in dims]
                for a, dims in cum_dims.items()
            }
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL, delimiter=";")
        data = []
        for col in self.log_columns:
            if col == mo.LOG_TIMESTAMP:
                data.append(
                    datetime.datetime.strftime(
                        datetime.datetime.now(), "%Y.%m.%d-%H.%M.%S"
                    )
                )
            elif col == mo.LOG_ENVIRONMENT:
                data.append(self._game_name())
            elif col == mo.LOG_ENV_SEED:
                data.append(self.get_env_seed())
            elif col in (mo.LOG_ENV_LAYOUT_SEED, mo.LOG_TRIAL):
                data.append(self.get_env_layout_seed())
            elif col == mo.LOG_EPISODE:
                data.append(self.get_episode_no())
            elif col == mo.LOG_ITERATION:
                data.append(iteration)
            elif col == mo.LOG_ARGUMENTS:
                data.append(str(self.log_arguments))
            elif col == mo.LOG_REWARD:
                if ref_mode:
                    # Iterating the dict gives agent-name cells.
                    data += [self.format_float(v) for v in reward_dims_f]
                else:
                    for a in self._agent_names:
                        data += [self.format_float(v)
                                 for v in per_agent_reward[a]]
            elif col in (mo.LOG_CUMULATIVE_REWARD, mo.LOG_AVERAGE_REWARD):
                if ref_mode:
                    dims = (cum_dims if col == mo.LOG_CUMULATIVE_REWARD
                            else avg_dims)
                    data += [self.format_float(v) for v in dims]
                else:
                    stat = observation.get(
                        CUMULATIVE_REWARD if col == mo.LOG_CUMULATIVE_REWARD
                        else AVERAGE_REWARD, {})
                    for a in self._agent_names:
                        data += [self.format_float(v)
                                 for v in np.atleast_1d(stat.get(a, []))]
            elif col == mo.LOG_SCALAR_REWARD:
                if ref_mode:
                    data.append(self.format_float(
                        {a: sum(reward_dims_f[a]) for a in alive}
                    ))
                else:
                    data += [self.format_float(per_agent_reward[a].sum())
                             for a in self._agent_names]
            elif col in (mo.LOG_SCALAR_CUMULATIVE_REWARD,
                         mo.LOG_SCALAR_AVERAGE_REWARD):
                cumulative = col == mo.LOG_SCALAR_CUMULATIVE_REWARD
                if ref_mode:
                    dims = cum_dims if cumulative else avg_dims
                    data.append(self.format_float(
                        {a: sum(d) for a, d in dims.items()}
                    ))
                else:
                    stat = observation.get(
                        CUMULATIVE_REWARD if cumulative else AVERAGE_REWARD,
                        {})
                    data += [self.format_float(np.sum(stat.get(a, 0.0)))
                             for a in self._agent_names]
            elif col in _AGENT_STAT_COLUMNS:
                if ref_mode:
                    # One str(dict) cell, dead agents skipped.
                    src = {
                        mo.LOG_GINI_INDEX: {
                            a: gini_coefficient(reward_dims_f[a]) * 100
                            for a in alive
                        },
                        mo.LOG_CUMULATIVE_GINI_INDEX: {
                            a: gini_coefficient(cum_dims[a]) * 100
                            for a in alive
                        },
                        mo.LOG_MO_VARIANCE: {
                            a: np.var(reward_dims_f[a], ddof=0)
                            for a in alive
                        },
                        mo.LOG_CUMULATIVE_MO_VARIANCE: {
                            a: np.var(cum_dims[a], ddof=0) for a in alive
                        },
                        mo.LOG_AVERAGE_MO_VARIANCE: {
                            a: np.var(avg_dims[a], ddof=0) for a in alive
                        },
                    }[col]
                    data.append(self.format_float(src))
                else:
                    values = observation.get(_AGENT_STAT_COLUMNS[col], {})
                    data += [self.format_float(values.get(a, 0.0))
                             for a in self._agent_names]
            elif col == mo.LOG_METRICS:
                metrics = self._current_metrics()
                keys = (self._reference_metrics_keys() if ref_mode
                        else self.metrics_keys)
                data += [self.format_float(metrics.get(k, None))
                         for k in keys]
            elif col == LOG_QVALUES_PER_TILETYPE:
                tile_types = self._environment_data.get(TILE_TYPES, [])
                if ref_mode:
                    # The reference looks up its agent-keyed store: with Q
                    # values the agent's {tile: vec} dict (whose iteration
                    # gives tile-char cells), without, len(alive) zeros.
                    for a in self._agent_names:
                        q = self.q_value_per_tiletype.get(
                            a, np.zeros([len(reward_dims_f)])
                        )
                        data += [self.format_float(v) for v in q]
                else:
                    for a in self._agent_names:
                        n_dims = len(self.enabled_agents_reward_dimensions[a])
                        agent_q = self.q_value_per_tiletype.get(a, {})
                        for t in tile_types:
                            q = agent_q.get(t, np.zeros([n_dims]))
                            data += [self.format_float(v) for v in q]
        writer.writerow(data)
        f.flush()

    def calculate_agents_observation_coordinates(
        self,
        observation,
        agent_observations,
        occlusion_in_layers=False,
        ascii=True,
        observe_from_agent_coordinates=None,
        observe_from_agent_directions=None,
    ):
        """For each agent, every layer's cells in the agent's perspective,
        offset so that the agent sits at (0, 0), as (x, y) pairs (the
        reference's order here)."""
        result = {}
        for agent_chr, agent_observation in agent_observations.items():
            layers = agent_observation.get(INFO_LAYERS, {})
            agent_coords = (
                np.argwhere(np.asarray(layers[agent_chr]))
                if agent_chr in layers
                else None
            )
            layer_coords = self.calculate_observation_coordinates(
                {**agent_observation, INFO_LAYERS: layers},
                occlusion_in_layers=occlusion_in_layers,
                ascii=ascii,
            )
            if agent_coords is not None and len(agent_coords) > 0:
                ay, ax = int(agent_coords[0][0]), int(agent_coords[0][1])
                result[agent_chr] = {
                    key: [(x - ax, y - ay) for (y, x) in coords]
                    for key, coords in layer_coords.items()
                }
            else:
                result[agent_chr] = []
        return result

    # ------------------------------------------- Q-value-per-tile logging

    def _update_q_values_ma(self, agents_actions, q_value_per_action):
        """Each acting agent's mean Q per destination cell and tile type."""
        if self._state is None:
            return
        board = np.asarray(self.char_board())
        minimum = int(self._game.action_min)
        deltas = self._movement_deltas()
        positions = self._lane()["pos"]
        h, w = board.shape
        impassable = set(
            getattr(self._game, "impassable_chars", "#")
        ) | set(self._agent_names)
        for a in agents_actions:
            if a not in q_value_per_action:
                continue
            idx = self._agent_names.index(a)
            per_location: dict = {}
            per_tiletype: dict = {}
            for action_index, q_value in enumerate(q_value_per_action[a]):
                action = minimum + action_index
                loc = (int(positions[idx][0]), int(positions[idx][1]))
                if 0 <= action < len(deltas):
                    dr, dc = deltas[action]
                    tr = min(max(loc[0] + int(dr), 0), h - 1)
                    tc = min(max(loc[1] + int(dc), 0), w - 1)
                    if chr(board[tr, tc]) not in impassable:
                        loc = (tr, tc)
                tile_type = chr(board[loc])
                per_location.setdefault(loc, []).append(q_value)
                per_tiletype.setdefault(tile_type, []).append(q_value)
            self.q_value_per_location.setdefault(a, {}).update(
                {k: np.mean(v, axis=0) for k, v in per_location.items()}
            )
            self.q_value_per_tiletype.setdefault(a, {}).update(
                {k: np.mean(v, axis=0) for k, v in per_tiletype.items()}
            )

    # ------------------------------------------------------------- stats

    def _attach_ma_stats(self, obs, step_rewards=None):
        """The per-agent statistics on the observation; ``step_rewards`` is
        the step's [n_agents, n_dims] rewards (zeros at reset). DEAD agents
        are left out of the per-step statistics, as in the reference."""
        lane = self._lane()
        iteration = int(lane["t"])
        metrics_dict = self._current_metrics()
        obs[METRICS_DICT] = metrics_dict
        obs[METRICS_MATRIX] = np.array(
            [[k, v] for k, v in metrics_dict.items()], dtype=object
        )
        types = lane["step_types"]
        cumulative = {}
        average = {}
        gini = {}
        cum_gini = {}
        variance = {}
        cum_var = {}
        avg_var = {}
        reward_dicts = {}
        cum_dicts = {}
        for i, a in enumerate(self._agent_names):
            dims = self._agent_reward_vector(self._episode_returns[i], a)
            avg = dims / (iteration + 1)
            cumulative[a] = (
                np.float64(dims.sum()) if self.scalarise else dims.copy()
            )
            average[a] = (
                np.float64(avg.sum()) if self.scalarise else avg.copy()
            )
            step_dims = self._agent_reward_vector(
                step_rewards[i] if step_rewards is not None
                else np.zeros_like(self._episode_returns[i]),
                a,
            )
            reward_dicts[a] = dict(
                zip(self.enabled_agents_reward_dimensions[a],
                    step_dims.tolist())
            )
            cum_dicts[a] = dict(
                zip(self.enabled_agents_reward_dimensions[a], dims.tolist())
            )
            if int(types[i]) == _DEAD:
                continue
            gini[a] = gini_coefficient(step_dims) * 100
            cum_gini[a] = gini_coefficient(dims) * 100
            variance[a] = np.var(step_dims, ddof=0)
            cum_var[a] = np.var(dims, ddof=0)
            avg_var[a] = np.var(avg, ddof=0)
        obs[CUMULATIVE_REWARD] = cumulative
        obs[AVERAGE_REWARD] = average
        obs[GINI_INDEX] = gini
        obs[CUMULATIVE_GINI_INDEX] = cum_gini
        obs[MO_VARIANCE] = variance
        obs[CUMULATIVE_MO_VARIANCE] = cum_var
        obs[AVERAGE_MO_VARIANCE] = avg_var
        obs[CUMULATIVE_REWARD_DICT] = cum_dicts
        obs[REWARD_DICT] = reward_dicts
        # The agents' directions.
        if "observation_direction" in lane:
            obs[INFO_OBSERVATION_DIRECTION] = {
                a: int(lane["observation_direction"][i])
                for i, a in enumerate(self._agent_names)
            }
        if "action_direction" in lane:
            obs[INFO_ACTION_DIRECTION] = {
                a: int(lane["action_direction"][i])
                for i, a in enumerate(self._agent_names)
            }

    def _finish_timestep(self, timestep, do_not_replace_reward):
        # The step computes its own per-agent statistics; the reset's are
        # attached here.
        if timestep.first():
            self._attach_ma_stats(timestep.observation)
        return timestep

    # ------------------------------------------------------- perspectives

    def agent_perspectives_with_layers(
        self,
        observation,
        include_layers=True,
        board=True,
        ascii=True,
        observe_from_agent_coordinates=None,
        observe_from_agent_directions=None,
    ):
        """Each agent's board, ascii and layers in its own perspective."""
        game = self._game
        lane = self._lane()
        obs_dirs = lane.get(
            "observation_direction", np.full((game.n_agents,), 2, np.int32)
        )
        positions = lane["pos"]
        outside_chr = ord(game.what_lies_outside)
        # The value table is a host array of the game.
        outside_value = float(np.asarray(game._value_lut)[outside_chr])

        out = {}
        for i, a in enumerate(self._agent_names):
            pos = (
                observe_from_agent_coordinates[a]
                if observe_from_agent_coordinates
                and a in observe_from_agent_coordinates
                else positions[i]
            )
            direction = (
                observe_from_agent_directions[a]
                if observe_from_agent_directions
                and a in observe_from_agent_directions
                else int(obs_dirs[i])
            )
            radius = (
                game.agent_observation_radii[i]
                if hasattr(game, "agent_observation_radii")
                else game.observation_radius
            )

            def persp(arr, fill):
                return agent_perspective(
                    np.asarray(arr),
                    pos,
                    direction,
                    fill,
                    observation_radius=radius,
                    observation_direction_mode=game.observation_direction_mode,
                )

            entry = {"layers": {}}
            if include_layers and "layers" in observation:
                for layer_key, layer in observation["layers"].items():
                    entry["layers"][layer_key] = persp(
                        np.asarray(layer),
                        layer_key == game.what_lies_outside,
                    )
            if board:
                entry["board"] = persp(observation["board"], outside_value)
            if ascii:
                codes = persp(observation["ascii_codes"], outside_chr)
                entry["ascii"] = codes.astype(np.uint32).view("U1")
            out[a] = entry
        return out

    def get_overall_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        mean = np.mean(np.stack(self._episodic_performances), axis=0)
        out = {}
        for i, a in enumerate(self._agent_names):
            dims = self._agent_reward_vector(mean[i], a)
            out[a] = np.float64(dims.sum()) if self.scalarise else dims
        return out

    def get_last_performance(self, default=None):
        if len(self._episodic_performances) < 1:
            return default
        last = self._episodic_performances[-1]
        return {
            a: (
                np.float64(self._agent_reward_vector(last[i], a).sum())
                if self.scalarise
                else self._agent_reward_vector(last[i], a)
            )
            for i, a in enumerate(self._agent_names)
        }

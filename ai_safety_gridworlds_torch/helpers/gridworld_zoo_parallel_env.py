"""PettingZoo Parallel adapter.

Port of ``ai_safety_gridworlds_tpu/helpers/gridworld_zoo_parallel_env.py``:
``possible_agents = ["agent_<chr>"]``, dict actions passed to the
multi-agent shell (which runs the randomized sequential sub-steps),
per-agent rewards, terminations, truncations and infos with an agent left
out once it is done, agent-perspective observations, the hidden-reward
deltas, the object coordinates and the layer cube in the infos, and the
``test_death`` fault injection. A single-agent env is driven as
``agent_0``.

The shell is built by ``factory.get_environment_obj(env_name, **kwargs)``
on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); every
value the adapter returns is numpy or a Python number. Where PettingZoo or
gymnasium is not installed, the base class and the spaces are the
stand-ins of :mod:`._spaces`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ai_safety_gridworlds_torch.core.timestep import StepType
from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.helpers._spaces import (
    Box,
    Discrete,
    ParallelEnv,
)
from ai_safety_gridworlds_torch.ma.safety_game_moma import (
    SafetyEnvironmentMoMa,
)

INFO_HIDDEN_REWARD = "hidden_reward"
INFO_OBSERVED_REWARD = "observed_reward"
INFO_DISCOUNT = "discount"


class GridworldZooParallelEnv(ParallelEnv):
    """Parallel-API adapter over a stateful shell of the port."""

    metadata = {"render_modes": ["human", "ansi", "rgb_array"]}

    def __init__(
        self,
        env_name: str,
        use_transitions: bool = False,
        flatten_observations: bool = False,
        scalarise: bool = False,
        test_death: bool = False,
        test_death_probability: float = 0.33,
        render_mode: Optional[str] = None,
        pass_through_arguments: Optional[dict] = None,
        observable_attribute_categories: Optional[list] = None,
        observable_attribute_value_mapping: Optional[dict] = None,
        object_coordinates_in_observation: bool = False,
        layers_order_in_cube: Optional[list] = None,
        **kwargs,
    ):
        self._object_coordinates_in_observation = (
            object_coordinates_in_observation
        )
        self._layers_order_in_cube = layers_order_in_cube
        self._env_name = env_name
        self._env = factory.get_environment_obj(
            env_name,
            scalarise=scalarise,
            **(pass_through_arguments or {}),
            **kwargs,
        )
        self._is_moma = isinstance(self._env, SafetyEnvironmentMoMa)
        if observable_attribute_categories and hasattr(
            self._env, "set_observable_attribute_categories"
        ):
            self._env.set_observable_attribute_categories(
                observable_attribute_categories,
                observable_attribute_value_mapping or {},
            )
        self._use_transitions = use_transitions
        self._flatten_observations = flatten_observations
        self._scalarise = scalarise
        self._test_death = test_death
        self._test_death_probability = test_death_probability
        self.render_mode = render_mode
        self._np_random = np.random.default_rng()

        if self._is_moma:
            chars = self._env.agent_names
        else:
            chars = ["0"]
        self.possible_agents = [f"agent_{c}" for c in chars]
        self.agent_name_mapping = dict(zip(self.possible_agents, chars))
        self.agent_name_reverse_mapping = {
            c: n for n, c in self.agent_name_mapping.items()
        }
        self._dones = {a: False for a in self.possible_agents}
        self._test_deads = {a: False for a in self.possible_agents}
        self._last_boards = {a: None for a in self.possible_agents}
        self._last_hidden_reward = {a: 0.0 for a in self.possible_agents}
        self._viewer = None

        spec = self._env.action_spec()
        if isinstance(spec, list):  # [discrete, continuous] for MoMa envs
            spec = spec[0]
        # The first discrete dimension is the ``step`` modality.
        step_min = int(np.asarray(spec.minimum).reshape(-1)[0])
        step_max = int(np.asarray(spec.maximum).reshape(-1)[0])
        self._action_spaces = {
            a: Discrete(n=step_max - step_min + 1, start=step_min)
            for a in self.possible_agents
        }
        # Per-agent observation shapes: the observation radii differ
        # between agents (firemaker's workers see 5x5, the supervisor the
        # whole map).
        depth = 2 if use_transitions else 1
        self._observation_spaces = {}
        for a, obs_shape in self._agent_board_shapes().items():
            shape = (depth,) + obs_shape
            if flatten_observations:
                shape = (int(np.prod(shape)),)
            self._observation_spaces[a] = Box(
                low=-np.inf, high=np.inf, shape=shape, dtype=np.float32
            )

    # -------------------------------------------------------------- helpers

    def _agent_board_shapes(self) -> dict:
        ts = self._env.reset()
        if self._is_moma:
            persp = self._env.agent_perspectives_with_layers(
                ts.observation, include_layers=False, ascii=False
            )
            return {
                name: tuple(persp[char]["board"].shape)
                for name, char in self.agent_name_mapping.items()
            }
        shape = tuple(ts.observation["board"].shape)
        return {a: shape for a in self.possible_agents}

    def _agent_observations(self, observation):
        """Per-agent boards (the perspectives of a multi-agent shell, the
        global board else)."""
        out = {}
        if self._is_moma:
            persp = self._env.agent_perspectives_with_layers(
                observation, include_layers=False, ascii=False
            )
            for name, char in self.agent_name_mapping.items():
                out[name] = np.asarray(persp[char]["board"], np.float32)
        else:
            for name in self.possible_agents:
                out[name] = np.asarray(observation["board"], np.float32)
        return out

    def _wrap(self, agent, board):
        board = np.asarray(board, np.float32)
        if self._use_transitions:
            last = self._last_boards[agent]
            if last is None:
                last = np.zeros_like(board)
            state = np.stack([last, board], axis=0)
            self._last_boards[agent] = board
        else:
            state = board[np.newaxis, :]
        if self._flatten_observations:
            state = state.flatten()
        return state

    # ------------------------------------------------------------------ api

    @property
    def agents(self):
        return [a for a in self.possible_agents if not self._dones[a]]

    @property
    def num_agents(self):
        return len(self.agents)

    @property
    def max_num_agents(self):
        return len(self.possible_agents)

    def action_space(self, agent):
        return self._action_spaces[agent]

    def observation_space(self, agent):
        return self._observation_spaces[agent]

    @property
    def action_spaces(self):
        return self._action_spaces

    @property
    def observation_spaces(self):
        return self._observation_spaces

    def reset(self, seed=None, options=None):
        if seed is not None:
            np.random.seed(seed)
            self._np_random = np.random.default_rng(seed)
        if self._is_moma and options:
            ts = self._env.reset(options=options)
        else:
            ts = self._env.reset()
        self._dones = {a: False for a in self.possible_agents}
        self._test_deads = {a: False for a in self.possible_agents}
        self._last_boards = {a: None for a in self.possible_agents}
        self._last_hidden_reward = {a: 0.0 for a in self.possible_agents}
        if self._viewer is not None:
            self._viewer.reset_time()
        boards = self._agent_observations(ts.observation)
        observations = {a: self._wrap(a, b) for a, b in boards.items()}
        infos = {a: {} for a in self.possible_agents}
        return observations, infos

    def step(self, actions):
        if self._is_moma:
            env_actions = {
                self.agent_name_mapping[a]: int(v)
                for a, v in actions.items()
                if not self._dones[a] and not self._test_deads[a]
            }
            ts = self._env.step(env_actions)
            step_types = ts.step_type
        else:
            action = next(iter(actions.values()))
            ts = self._env.step(int(np.asarray(action).item()))
            step_types = {"0": ts.step_type}

        observations, rewards, terminations, truncations, infos = (
            {},
            {},
            {},
            {},
            {},
        )
        boards = self._agent_observations(ts.observation)
        hidden_deltas = self._hidden_reward_deltas()
        for name in self.possible_agents:
            if self._dones[name]:
                continue
            char = self.agent_name_mapping[name]
            st = (
                step_types[char]
                if isinstance(step_types, dict)
                else step_types
            )
            reward = (
                ts.reward[char]
                if isinstance(ts.reward, dict)
                else ts.reward
            )
            if reward is None:
                reward = 0.0
            done = int(st) in (int(StepType.LAST), int(StepType.DEAD))
            # Fault injection: a live agent dies at random.
            if (
                self._test_death
                and not done
                and self._np_random.random() < self._test_death_probability
            ):
                self._test_deads[name] = True
                done = True
            terminations[name] = done
            truncations[name] = False
            rewards[name] = (
                np.float64(np.sum(reward)) if self._scalarise else reward
            )
            observations[name] = self._wrap(name, boards[name])
            infos[name] = {
                INFO_OBSERVED_REWARD: rewards[name],
                INFO_HIDDEN_REWARD: hidden_deltas[name],
                INFO_DISCOUNT: ts.discount,
            }
            infos[name].update(self._extra_info(ts.observation))
            if done:
                self._dones[name] = True
        # An agent done in an earlier step was skipped above, so it is
        # absent from every returned dict.
        return observations, rewards, terminations, truncations, infos

    def _hidden_reward_deltas(self) -> dict:
        """Per-agent hidden-reward change since the previous step: the
        shell keeps the episode's cumulative hidden reward and the adapter
        differences it. None where no entity has written a hidden
        reward."""
        cumulative = self._env._get_hidden_reward(default_reward=None)
        if cumulative is None:
            return {a: None for a in self.possible_agents}
        deltas = {}
        if isinstance(cumulative, dict):
            for name, char in self.agent_name_mapping.items():
                deltas[name] = (
                    cumulative[char] - self._last_hidden_reward[name]
                )
                self._last_hidden_reward[name] = cumulative[char]
        else:
            value = float(np.sum(cumulative))
            first = self.possible_agents[0]
            delta = value - self._last_hidden_reward[first]
            self._last_hidden_reward[first] = value
            deltas = {a: delta for a in self.possible_agents}
        return deltas

    def _extra_info(self, obs) -> dict:
        """The optional info fields of the global observation (object
        coordinates, the layer cube), as the Gym adapter gives them."""
        extra = {}
        env = self._env
        if self._object_coordinates_in_observation and hasattr(
            env, "calculate_observation_coordinates"
        ):
            extra["info_observation_coordinates"] = (
                env.calculate_observation_coordinates(obs)
            )
        if self._layers_order_in_cube is not None and hasattr(
            env, "calculate_observation_layers_cube"
        ):
            order = env.get_layers_order(
                obs, layers_order=self._layers_order_in_cube
            )
            extra["info_observation_layers_order"] = order
            extra["info_observation_layers_cube"] = (
                env.calculate_observation_layers_cube(
                    obs, layers_order=order
                )
            )
        return extra

    def render(self, mode=None):
        mode = mode or self.render_mode or "ansi"
        if mode == "ansi":
            board = np.asarray(self._env.char_board())
            return "\n".join("".join(chr(c) for c in row) for row in board)
        obs = self._env.last_observation()
        if mode == "rgb_array":
            return np.transpose(np.asarray(obs["RGB"]), (1, 2, 0))
        if mode == "human":
            from ai_safety_gridworlds_torch.helpers.agent_viewer import (
                AgentViewer,
            )

            if self._viewer is None:
                self._viewer = AgentViewer(pause=0.1)
            self._viewer.display(self._env)
            return None
        raise NotImplementedError(mode)

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if hasattr(self._env, "close"):
            self._env.close()

    def get_env_layout_seed(self):
        return self._env.get_env_layout_seed()

    def get_trial_no(self):
        return self._env.get_trial_no()

    def get_episode_no(self):
        return self._env.get_episode_no()

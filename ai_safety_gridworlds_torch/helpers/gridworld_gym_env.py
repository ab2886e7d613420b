"""Gym / Gymnasium adapter for the safety gridworld environments.

Port of ``ai_safety_gridworlds_tpu/helpers/gridworld_gym_env.py``: board or
ASCII observations with optional transition stacking and flattening, an
info dict with the observed and hidden rewards and the discount, Discrete
or MultiDiscrete action spaces with a non-zero least action, ``ansi``,
``rgb_array`` and ``human`` rendering, and the MO shell's accessors (layout
seed, trial and episode numbers, the Q-value passthrough).

The adapter steps a stateful shell of the port, built by
``factory.get_environment_obj(env_name, **kwargs)``: ``device`` flows
through and is ``"cuda"`` unless the caller asks for ``"cpu"``, and
asking for the card on a machine without one raises. Every observation,
reward and info value it returns is a numpy array, a numpy scalar or a
Python number, never a tensor. Where neither gymnasium nor gym is
installed, the spaces and the ``Env`` base are the stand-ins of
:mod:`._spaces`.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from ai_safety_gridworlds_torch.helpers import factory
from ai_safety_gridworlds_torch.helpers._spaces import (
    Box,
    Discrete,
    Env,
    MultiDiscrete,
    gym_v26,
)
from ai_safety_gridworlds_torch.helpers.safety_env import EXTRA_OBSERVATIONS
from ai_safety_gridworlds_torch.mo.safety_game_mo import SafetyEnvironmentMo

INFO_HIDDEN_REWARD = "hidden_reward"
INFO_OBSERVED_REWARD = "observed_reward"
INFO_DISCOUNT = "discount"
INFO_OBSERVATION_COORDINATES = "info_observation_coordinates"
INFO_OBSERVATION_LAYERS_DICT = "info_observation_layers_dict"
INFO_OBSERVATION_LAYERS_ORDER = "info_observation_layers_order"
INFO_OBSERVATION_LAYERS_CUBE = "info_observation_layers_cube"
INFO_AGENT_OBSERVATIONS = "info_agent_observations"
INFO_AGENT_OBSERVATION_COORDINATES = "info_agent_observation_coordinates"
INFO_AGENT_OBSERVATION_LAYERS_DICT = "info_agent_observation_layers_dict"
INFO_AGENT_OBSERVATION_LAYERS_ORDER = "info_agent_observation_layers_order"
INFO_AGENT_OBSERVATION_LAYERS_CUBE = "info_agent_observation_layers_cube"


class GridworldGymEnv(Env):
    """Gym environment wrapping a safety gridworld shell of the port."""

    metadata = {"render_modes": ["human", "ansi", "rgb_array"],
                "render.modes": ["human", "ansi", "rgb_array"]}

    def __init__(
        self,
        env_name: str,
        use_transitions: bool = False,
        flatten_observations: bool = False,
        ascii_observation_format: bool = False,
        render_mode: Optional[str] = None,
        render_animation_delay: float = 0.1,
        use_multi_discrete_action_space: bool = False,
        pass_through_arguments: Optional[dict] = None,
        object_coordinates_in_observation: bool = False,
        layers_order_in_cube: Optional[list] = None,
        occlusion_in_layers: bool = False,
        agent_character: Optional[str] = None,
        pre_step_callback=None,
        **kwargs,
    ):
        # An optional action rewriter called before each step.
        self._pre_step_callback = pre_step_callback
        self._env_name = env_name
        self._env = factory.get_environment_obj(
            env_name, **(pass_through_arguments or {}), **kwargs
        )
        self._use_transitions = use_transitions
        self._flatten_observations = flatten_observations
        self._ascii_observation_format = ascii_observation_format
        self._object_coordinates_in_observation = (
            object_coordinates_in_observation
        )
        self._layers_order_in_cube = layers_order_in_cube
        self._occlusion_in_layers = occlusion_in_layers
        # A multi-agent env driven as a single agent: only this agent takes
        # the Gym action, the others take none.
        agent_names = getattr(self._env, "agent_names", None)
        self._agent_chr = (
            (agent_character or agent_names[0]) if agent_names else None
        )
        self.render_mode = render_mode
        self._render_animation_delay = render_animation_delay
        self._viewer = None
        self._last_board = None
        self._state = None
        self._last_hidden_reward = 0.0
        self._cumulative_reward = 0.0
        self._np_random = np.random.default_rng()

        if use_multi_discrete_action_space:
            self.action_space = MultiDiscreteGridworldsActionSpace(self)
        else:
            self.action_space = DiscreteGridworldsActionSpace(self)
        self.observation_space = GridworldsObservationSpace(
            self, use_transitions, flatten_observations
        )

    # ------------------------------------------------------------------ api

    def step(self, action, *args, **kwargs):
        if self._pre_step_callback is not None:
            action = self._pre_step_callback(action, *args, **kwargs)
        if self._agent_chr is not None:
            timestep = self._env.step(
                {self._agent_chr: action}, *args, **kwargs
            )
        else:
            timestep = self._env.step(action, *args, **kwargs)
        obs = timestep.observation

        reward = timestep.reward
        if self._agent_chr is not None and isinstance(reward, dict):
            reward = reward.get(self._agent_chr)
        reward = 0.0 if reward is None else reward
        cumulative_hidden = self._env._get_hidden_reward(default_reward=None)
        if isinstance(cumulative_hidden, dict):
            cumulative_hidden = cumulative_hidden.get(self._agent_chr)
        if cumulative_hidden is not None:
            hidden_reward = cumulative_hidden - self._last_hidden_reward
            self._last_hidden_reward = cumulative_hidden
        else:
            hidden_reward = None

        info = self._compute_info(obs)
        info.update(
            {
                INFO_HIDDEN_REWARD: hidden_reward,
                INFO_OBSERVED_REWARD: reward,
                INFO_DISCOUNT: timestep.discount,
            }
        )

        board = copy.deepcopy(
            obs["ascii" if self._ascii_observation_format else "board"]
        )
        if self._use_transitions:
            state = np.stack([self._last_board, board], axis=0)
            self._last_board = board
        else:
            state = board[np.newaxis, :]
        if self._flatten_observations:
            state = state.flatten()
        self._state = state

        st = timestep.step_type
        if isinstance(st, dict):
            agent_st = st.get(self._agent_chr)
            done = agent_st is not None and int(agent_st) in (2, 3)
        else:
            done = st.last()
        # An MO env keeps its per-dimension vector (0.0 + vector broadcasts).
        if reward is not None:
            self._cumulative_reward = (
                self._cumulative_reward + np.asarray(reward)
            )

        if gym_v26:
            return state, reward, done, False, info
        return state, reward, done, info

    def reset(self, seed=None, return_info=False, *args, **kwargs):
        if seed is not None:
            self.seed(seed=seed)
        # Only the MO and multi-agent shells take reset options.
        if isinstance(self._env, SafetyEnvironmentMo):
            if kwargs.get("options") is None:
                kwargs.pop("options", None)
            timestep = self._env.reset(*args, **kwargs)
        else:
            timestep = self._env.reset()
        if self._viewer is not None:
            self._viewer.reset_time()
        obs = timestep.observation
        info = self._compute_info(obs)

        board = copy.deepcopy(
            obs["ascii" if self._ascii_observation_format else "board"]
        )
        if self._use_transitions:
            state = np.stack([np.zeros_like(board), board], axis=0)
            self._last_board = board
        else:
            state = board[np.newaxis, :]
        if self._flatten_observations:
            state = state.flatten()
        self._state = state
        self._last_hidden_reward = 0.0
        self._cumulative_reward = 0.0

        if gym_v26 or return_info:
            return state, info
        return state

    def seed(self, seed=None):
        self._np_random = np.random.default_rng(seed)
        np.random.seed(seed)
        return [seed]

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if hasattr(self._env, "close"):
            self._env.close()

    def render(self, mode=None):
        """The board as text (``ansi``), as an RGB frame (``rgb_array``) or
        on the terminal viewer (``human``)."""
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
                self._viewer = AgentViewer(
                    pause=self._render_animation_delay
                )
            self._viewer.display(self._env)
            return None
        raise NotImplementedError(mode)

    # -------------------------------------------------------------- helpers

    def _compute_info(self, obs):
        info = {
            k: v
            for k, v in obs.items()
            if k not in ("board", "RGB", "ascii")
        }
        extra = info.pop(EXTRA_OBSERVATIONS, {})
        info.update(extra)

        env = self._env
        if self._object_coordinates_in_observation and hasattr(
            env, "calculate_observation_coordinates"
        ):
            info[INFO_OBSERVATION_COORDINATES] = (
                env.calculate_observation_coordinates(
                    obs, occlusion_in_layers=self._occlusion_in_layers
                )
            )
        if self._layers_order_in_cube is not None and hasattr(
            env, "calculate_observation_layers_cube"
        ):
            order = env.get_layers_order(
                obs,
                occlusion_in_layers=self._occlusion_in_layers,
                layers_order=self._layers_order_in_cube,
            )
            info[INFO_OBSERVATION_LAYERS_ORDER] = order
            info[INFO_OBSERVATION_LAYERS_CUBE] = (
                env.calculate_observation_layers_cube(
                    obs,
                    occlusion_in_layers=self._occlusion_in_layers,
                    layers_order=order,
                )
            )
        if self._agent_chr is not None and hasattr(
            env, "agent_perspectives_with_layers"
        ):
            persp = env.agent_perspectives_with_layers(
                obs, include_layers=not self._occlusion_in_layers
            )
            agent_obs = persp[self._agent_chr]
            info[INFO_AGENT_OBSERVATIONS] = agent_obs[
                "ascii" if self._ascii_observation_format else "board"
            ]
            if not self._occlusion_in_layers:
                info[INFO_AGENT_OBSERVATION_LAYERS_DICT] = agent_obs.get(
                    "layers"
                )
            if self._object_coordinates_in_observation and hasattr(
                env, "calculate_agents_observation_coordinates"
            ):
                coords = env.calculate_agents_observation_coordinates(
                    obs,
                    persp,
                    occlusion_in_layers=self._occlusion_in_layers,
                )
                info[INFO_AGENT_OBSERVATION_COORDINATES] = coords[
                    self._agent_chr
                ]
            if self._layers_order_in_cube is not None:
                order = env.get_layers_order(
                    agent_obs,
                    occlusion_in_layers=self._occlusion_in_layers,
                    layers_order=self._layers_order_in_cube,
                )
                info[INFO_AGENT_OBSERVATION_LAYERS_ORDER] = order
                info[INFO_AGENT_OBSERVATION_LAYERS_CUBE] = (
                    env.calculate_observation_layers_cube(
                        agent_obs,
                        occlusion_in_layers=self._occlusion_in_layers,
                        layers_order=order,
                    )
                )
        return info

    @property
    def episode_return(self):
        return self._cumulative_reward

    def get_reward_unit_space(self):
        return self._env.get_reward_unit_space()

    def get_env_layout_seed(self):
        return self._env.get_env_layout_seed()

    def get_trial_no(self):
        return self._env.get_trial_no()

    def get_episode_no(self):
        return self._env.get_episode_no()

    def get_next_episode_no(self):
        return self._env.get_next_episode_no()

    def set_current_q_value_per_action(self, q_value_per_action=None):
        return self._env.set_current_q_value_per_action(q_value_per_action)


def _action_bounds(env):
    """The least and largest step action of the wrapped shell (the
    multi-agent shell's spec is ``[discrete, continuous]``)."""
    spec = env._env.action_spec()
    if isinstance(spec, list):
        spec = spec[0]
    return (int(np.asarray(spec.minimum).reshape(-1)[0]),
            int(np.asarray(spec.maximum).reshape(-1)[0]))


class MultiDiscreteGridworldsActionSpace(MultiDiscrete):
    """A one-dimensional MultiDiscrete action space with a non-zero least
    action."""

    def __init__(self, env):
        self._env = env
        self.min_action, self.max_action = _action_bounds(env)
        self.n = (self.max_action - self.min_action) + 1
        if gym_v26:
            super().__init__(
                nvec=[self.n], start=[self.min_action], dtype=np.int32
            )
        else:
            super().__init__(nvec=[self.n], dtype=np.int32)

    def sample(self, mask=None):
        result = super().sample(mask)
        if not gym_v26:
            result = result + self.min_action
        return result

    def contains(self, x):
        return bool(
            np.all(self.min_action <= np.asarray(x))
            and np.all(np.asarray(x) <= self.max_action)
        )


class DiscreteGridworldsActionSpace(Discrete):
    """A Discrete action space starting at the least action."""

    def __init__(self, env):
        self._env = env
        self.min_action, self.max_action = _action_bounds(env)
        n = (self.max_action - self.min_action) + 1
        super().__init__(n=n, start=self.min_action)

    def contains(self, x):
        return self.min_action <= int(x) <= self.max_action


class GridworldsObservationSpace(Box):
    """The observation space of the board spec, stacked and flattened as
    the adapter's options ask."""

    def __init__(self, env, use_transitions, flatten_observations):
        self._env = env
        spec = env._env.observation_spec()["board"]
        depth = 2 if use_transitions else 1
        shape = (depth,) + tuple(spec.shape)
        if flatten_observations:
            shape = (int(np.prod(shape)),)
        super().__init__(
            low=-np.inf, high=np.inf, shape=shape, dtype=np.float32
        )

    def contains(self, x):
        return np.asarray(x).shape == self.shape

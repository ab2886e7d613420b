"""The library classes the Gym and PettingZoo adapters build on.

The adapters take ``Env``, ``Box``, ``Discrete`` and ``MultiDiscrete`` from
``gymnasium`` where it imports, else from ``gym`` (``gym_v26`` tells the
two apart), and ``ParallelEnv`` / ``AECEnv`` from ``pettingzoo``. Where a
library is not installed, the stand-ins below take its place: they hold
only the members the adapters and their callers use (``shape``,
``dtype``, ``low`` / ``high``, ``n``, ``start``, ``nvec``, ``seed``, an
action space's ``sample`` from the space's own generator, and
``contains`` where the adapter's own space class does not define it) and
draw their samples as gymnasium 1.x does, so a seeded space gives the
same actions with or without the library. They touch neither the device
nor a kernel.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import Env
    from gymnasium.spaces import Box, Discrete, MultiDiscrete

    gym_v26 = True
except ImportError:
    try:
        import gym
        from gym import Env
        from gym.spaces import Box, Discrete, MultiDiscrete

        gym_v26 = False
    except ImportError:
        gym = None
        gym_v26 = True  # the stand-ins follow gymnasium's API

try:
    from pettingzoo.utils.env import AECEnv, ParallelEnv
except ImportError:
    ParallelEnv = AECEnv = None


class _Space:
    """A space with its own generator, seeded as gymnasium seeds one."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._np_random = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed()
        return self._np_random

    def seed(self, seed=None):
        seq = np.random.SeedSequence(seed)
        self._np_random = np.random.Generator(np.random.PCG64(seq))
        return seq.entropy


class _Box(_Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        shape = tuple(shape) if shape is not None else np.shape(low)
        super().__init__(shape, dtype)
        self.low = np.full(shape, low, dtype=self.dtype)
        self.high = np.full(shape, high, dtype=self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return bool(x.shape == self.shape and np.all(x >= self.low)
                    and np.all(x <= self.high))


class _Discrete(_Space):
    def __init__(self, n, start=0):
        super().__init__((), np.int64)
        self.n = np.int64(n)
        self.start = np.int64(start)

    def sample(self, mask=None):
        if mask is not None:
            raise NotImplementedError("the stand-in space samples no mask")
        return self.start + self.np_random.integers(self.n, dtype=np.int64)

    def contains(self, x):
        return bool(self.start <= int(x) < self.start + self.n)


class _MultiDiscrete(_Space):
    def __init__(self, nvec, dtype=np.int64, start=None):
        self.nvec = np.asarray(nvec, dtype=dtype)
        super().__init__(self.nvec.shape, dtype)
        self.start = (np.zeros_like(self.nvec) if start is None
                      else np.asarray(start, dtype=dtype))

    def sample(self, mask=None):
        if mask is not None:
            raise NotImplementedError("the stand-in space samples no mask")
        return (self.np_random.random(self.nvec.shape)
                * self.nvec).astype(self.dtype) + self.start


class _Env:
    """What the adapters take from ``gymnasium.Env`` and PettingZoo's
    ``ParallelEnv`` and ``AECEnv``."""

    @property
    def unwrapped(self):
        return self


if gym is None:
    Env, Box, Discrete, MultiDiscrete = _Env, _Box, _Discrete, _MultiDiscrete
if ParallelEnv is None:
    ParallelEnv = AECEnv = _Env

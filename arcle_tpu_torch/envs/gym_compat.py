"""Gymnasium adapters over the port's single-env engines.

Counterpart of ``arcle_tpu/envs/gym_compat.py``: ``RawARCEnv``,
``ARCEnv``, ``O2ARCv2Env`` and ``O2ARCNoFillEnv`` keep the reference's
constructor signature (base.py:37-43) plus ``backend`` and ``device``,
its observation and action spaces (base.py:121-138, o2arcenv.py:36-74),
reset options (base.py:87-93), info dict (base.py:145-153), sparse reward
and ANSI rendering.

``backend`` picks the engine behind :attr:`TorchARCEnvBase.engine`:

* ``"auto"`` (the default) and ``"torch"``: :class:`~.single.TorchEngine`
  on ``device`` (default ``"cuda"``): the CUDA step kernel at B=1 on the
  card, the plain transition with ``device="cpu"``.  Without a card and
  without ``device="cpu"`` construction raises; nothing falls back.
* ``"native"``: the C++ engine on the host
  (:class:`~arcle_tpu_torch.native.NativeEngine`); raises if it does not
  build.  Its observations are views of the live engine state, changed by
  the next step, as the reference's ``current_state`` is.

A documented divergence from ``arcle_tpu``, whose ``"auto"`` prefers the
native engine: the port's entry points run on the card unless the caller
asks otherwise.

``gymnasium`` is optional.  Where it imports, the adapters are
``gymnasium.Env`` subclasses; where it does not, they stand on a small
base that gives ``np_random`` the stream gymnasium would give for a seed,
``unwrapped`` and ``close``, and ``observation_space`` / ``action_space``
are None.

Unseeded task sampling uses the loader's own Generator and the env's
``np_random``, not the reference's global numpy RNG (as in ``arcle_tpu``);
parity tests pin explicit indices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..loaders import ARCLoader, Loader
from ..native import NativeEngine
from ..ops.table import OpTable, arc_table, o2arc_table, raw_table
from .single import TorchEngine

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:
    gym = spaces = None

BACKENDS = ("auto", "torch", "native")


class _PlainEnv:
    """What the adapters use of ``gymnasium.Env`` where it is missing."""

    metadata: Dict = {}
    _np_random: Optional[np.random.Generator] = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None):
        if seed is not None:
            self._np_random = _generator(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = _generator(None)
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random = value

    @property
    def unwrapped(self):
        return self

    def close(self) -> None:
        pass


def _generator(seed: Optional[int]) -> np.random.Generator:
    """``gymnasium.utils.seeding.np_random(seed)``'s generator."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


def make_engine(backend: str, table: OpTable, H: int, W: int,
                max_trial: int, device="cuda"):
    """The single-env engine that ``backend`` names (see the module)."""
    if backend in ("auto", "torch"):
        return TorchEngine(table, H, W, max_trial, device)
    if backend == "native":
        return NativeEngine(table, H, W, max_trial)
    if backend == "jax":
        raise ValueError('backend="jax" is arcle_tpu\'s; the port steps with '
                         'backend="torch" (the card, or device="cpu") or '
                         '"native"')
    raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")


class TorchARCEnvBase(gym.Env if gym is not None else _PlainEnv):
    """Common adapter machinery (counterpart of ``JaxARCEnvBase``)."""

    metadata = {"render_modes": ["ansi"], "render_fps": 5}
    _obs_keys: Tuple[str, ...] = ()

    def __init__(self, data_loader: Optional[Loader] = None,
                 max_grid_size: Tuple[int, int] = (30, 30),
                 colors: int = 10, max_trial: int = -1,
                 render_mode: Optional[str] = None,
                 render_size: Optional[Tuple[int, int]] = None,
                 backend: str = "auto", device="cuda") -> None:
        if render_mode is not None and \
                render_mode not in self.metadata["render_modes"]:
            raise ValueError(f"render_mode {render_mode!r}: expected one of "
                             f"{self.metadata['render_modes']}")
        # the object ops assume square frames (the reference's own envs
        # and datasets only use square sizes)
        if max_grid_size[0] != max_grid_size[1]:
            raise ValueError(f"max_grid_size {max_grid_size}: square only")
        self.loader = data_loader if data_loader is not None else ARCLoader()
        self.H, self.W = max_grid_size
        self.max_grid_size = max_grid_size
        self.colors = colors
        self.max_trial = max_trial
        self.render_mode = render_mode
        self.render_size = render_size
        self.rendering = None

        self.table = self._make_table(max_trial)
        self.engine = make_engine(backend, self.table, self.H, self.W,
                                  max_trial, device)
        self.op_names: List[str] = list(self.table.op_names())
        # the reference exposes `operations` as the op list; wrappers only
        # use its length, so the names stand in for its closures
        self.operations = self.op_names

        if spaces is not None:
            self.observation_space = self.create_state_space()
            self.action_space = self.create_action_space(self.table.n_ops)
        else:
            self.observation_space = self.action_space = None

        self.last_action: Optional[Dict] = None
        self.last_action_op: Optional[int] = None
        self.last_reward: float = 0.0
        self.action_steps: int = 0
        self.submit_count: int = 0
        self.truncated = False
        self.input_: Optional[np.ndarray] = None
        self.answer: Optional[np.ndarray] = None
        self.description: Dict = {}

    @property
    def current_state(self) -> Dict:
        """The full observation dict (the reference's ``current_state``,
        base.py:24)."""
        return self._observation()

    # ---- reference-parity construction hooks ----
    def _make_table(self, max_trial: int) -> OpTable:
        raise NotImplementedError

    def create_state_space(self):
        return spaces.Dict({
            "trials_remain": spaces.Box(-1, self.max_trial, shape=(1,),
                                        dtype=np.int8),
            "terminated": spaces.MultiBinary(1),
            "input": spaces.Box(0, self.colors, (self.H, self.W),
                                dtype=np.int8),
            "input_dim": spaces.Box(low=np.array([1, 1]),
                                    high=np.array([self.H, self.W]),
                                    dtype=np.int8),
            "grid": spaces.Box(0, self.colors, (self.H, self.W),
                               dtype=np.int8),
            "grid_dim": spaces.Box(low=np.array([1, 1]),
                                   high=np.array([self.H, self.W]),
                                   dtype=np.int8),
        })

    def create_action_space(self, action_count: int):
        return spaces.Dict({
            "selection": spaces.Box(0, 1, (self.H, self.W), dtype=np.int8),
            "operation": spaces.Discrete(action_count),
        })

    # ---- gym API ----
    def reset(self, seed: Optional[int] = None,
              options: Optional[Dict] = None):
        super().reset(seed=seed, options=options)
        self.truncated = False
        self.submit_count = 0
        self.last_action = None
        self.last_action_op = None
        self.last_reward = 0.0
        self.action_steps = 0

        self.prob_index = None
        self.subprob_index = None
        self.adaptation = True
        self.reset_on_submit = False
        self.options = options
        if options is not None:
            self.prob_index = options.get("prob_index")
            self.subprob_index = options.get("subprob_index")
            ad = options.get("adaptation")
            self.adaptation = True if ad is None else bool(ad)
            ros = options.get("reset_on_submit")
            self.reset_on_submit = False if ros is None else ros

        ex_in, ex_out, tt_in, tt_out, desc = self.loader.pick(
            data_index=self.prob_index)
        pool_in, pool_out = (ex_in, ex_out) if self.adaptation \
            else (tt_in, tt_out)
        if self.subprob_index is None:
            self.subprob_index = int(self.np_random.integers(0, len(pool_in)))
        self.input_ = pool_in[self.subprob_index]
        self.answer = pool_out[self.subprob_index]
        self.description = desc

        self._reset_engine()
        if self.render_mode:
            self.render()
        self.info = self.init_info()
        return self._observation(), self.info

    def _reset_engine(self) -> None:
        self.engine.reset(self.input_, self.answer,
                          reset_on_submit=bool(self.reset_on_submit))

    def init_info(self) -> Dict:
        isize = self.input_.shape
        osize = self.answer.shape
        return {
            "input": np.pad(self.input_, [(0, self.H - isize[0]),
                                          (0, self.W - isize[1])]),
            "input_dim": isize,
            "answer": np.pad(self.answer, [(0, self.H - osize[0]),
                                           (0, self.W - osize[1])]),
            "answer_dim": osize,
            "steps": 0,
        }

    def step(self, action: Dict):
        op = int(action["operation"])
        reward, term = self.engine.step(
            np.asarray(action["selection"], np.int8), op)
        self.last_action = action
        self.last_action_op = op
        self.last_reward = reward
        self.action_steps += 1
        self.submit_count = self.engine.submit_count
        self.info["steps"] = self.action_steps
        if "submit_count" in self.info:
            self.info["submit_count"] = self.submit_count
        if self.render_mode:
            self.render()
        return (self._observation(), reward, bool(term), self.truncated,
                self.info)

    def _observation(self) -> Dict:
        return self.engine.observation(self._obs_keys)

    # ---- rendering ----
    def render(self):
        if self.render_mode == "ansi":
            self.render_ansi()

    def render_ansi(self):
        # imported here: utils imports the training stack, which imports
        # this package
        from ..utils.render import render_ansi_core
        first = self.rendering is None
        self.rendering = True
        op_name = (self.op_names[self.last_action_op]
                   if self.last_action_op is not None else "")
        render_ansi_core(self._observation(), self.description, op_name,
                         self.last_reward, first=first)


class RawARCEnv(TorchARCEnvBase):
    """12-op env (arcenv.py:16-76)."""

    _obs_keys = ()

    def __init__(self, data_loader: Optional[Loader] = None,
                 max_grid_size=(30, 30), colors=10, max_trial=-1,
                 render_mode=None, render_size=None, backend="auto",
                 device="cuda"):
        super().__init__(data_loader, max_grid_size, colors, max_trial,
                         render_mode, render_size, backend, device)

    def _make_table(self, max_trial: int) -> OpTable:
        return raw_table(max_trial)


class ARCEnv(TorchARCEnvBase):
    """27-op testing-interface env (arcenv.py:78-217, with arcle_tpu's fix
    of the reference's ``[None]*35`` construction crash and ``len(ops)-1``
    reward index to the documented 27-op intent)."""

    _obs_keys = ("clip",)

    def __init__(self, data_loader: Optional[Loader] = None,
                 max_grid_size=(30, 30), colors=10, max_trial=3,
                 render_mode=None, render_size=None, backend="auto",
                 device="cuda"):
        super().__init__(data_loader, max_grid_size, colors, max_trial,
                         render_mode, render_size, backend, device)

    def _make_table(self, max_trial: int) -> OpTable:
        return arc_table(max_trial)

    def create_state_space(self):
        sp = dict(super().create_state_space().spaces)
        sp["clip"] = spaces.Box(0, self.colors, (self.H, self.W),
                                dtype=np.int8)
        sp["clip_dim"] = spaces.Box(low=np.array([0, 0]),
                                    high=np.array([self.H, self.W]),
                                    dtype=np.int8)
        return spaces.Dict(sp)

    def init_info(self) -> Dict:
        info = super().init_info()
        info["submit_count"] = 0
        return info


class O2ARCv2Env(TorchARCEnvBase):
    """Full 35-op O2ARC interface env (o2arcenv.py:13-193)."""

    _obs_keys = ("clip", "selected")

    def __init__(self, data_loader: Optional[Loader] = None,
                 max_grid_size=(30, 30), colors=10, max_trial=-1,
                 render_mode=None, render_size=None, backend="auto",
                 device="cuda"):
        super().__init__(data_loader, max_grid_size, colors, max_trial,
                         render_mode, render_size, backend, device)

    def _make_table(self, max_trial: int) -> OpTable:
        return o2arc_table(max_trial)

    def create_state_space(self):
        sp = dict(super().create_state_space().spaces)
        box = lambda lo, hi: spaces.Box(low=np.array(lo), high=np.array(hi),
                                        dtype=np.int8)
        grid = lambda hi: spaces.Box(0, hi, (self.H, self.W), dtype=np.int8)
        sp.update({
            "selected": grid(1),
            "clip": grid(self.colors),
            "clip_dim": box([0, 0], [self.H, self.W]),
            "object_states": spaces.Dict({
                "active": spaces.MultiBinary(1),
                "object": grid(self.colors),
                "object_sel": grid(1),
                "object_dim": box([0, 0], [self.H, self.W]),
                "object_pos": box([-128, -128], [127, 127]),
                "background": grid(self.colors),
                "rotation_parity": spaces.MultiBinary(1),
            }),
        })
        return spaces.Dict(sp)

    def init_info(self) -> Dict:
        info = super().init_info()
        info["submit_count"] = 0
        return info

    def render_ansi(self):
        from ..utils.render import render_ansi_o2
        first = self.rendering is None
        self.rendering = True
        op_name = (self.op_names[self.last_action_op]
                   if self.last_action_op is not None else "")
        sel_flag = (self.last_action is not None
                    and bool(np.any(self.last_action["selection"])))
        render_ansi_o2(self._observation(), self.description, op_name,
                       self.last_reward, sel_flag, first=first)


class O2ARCNoFillEnv(O2ARCv2Env):
    """O2ARC minus the FloodFill ops (agents/wrapper.py:53-57)."""

    def _make_table(self, max_trial: int) -> OpTable:
        return o2arc_table(max_trial, no_fill=True)


__all__ = ["TorchARCEnvBase", "RawARCEnv", "ARCEnv", "O2ARCv2Env",
           "O2ARCNoFillEnv", "make_engine", "BACKENDS"]

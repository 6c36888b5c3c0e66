"""One environment on a device: the gym adapters' ``backend="torch"``.

:class:`TorchEngine` has the surface of :class:`~arcle_tpu_torch.native.
NativeEngine` (``reset``, ``step``, ``run``, ``observation``,
``state_dict``) over a batch of one :class:`~arcle_tpu_torch.core.state.
EnvState` on ``device``.  It steps through
:func:`~arcle_tpu_torch.ops.step_kernel.complete_step`, the step of
``BatchedEnv``: on the card the CUDA step kernel at B=1, on the CPU the
plain transition.

Each step moves one buffer each way: the selection and the op go up in
one host-to-device copy, and the observed fields come back packed in one
device-to-host copy.  Observations are fresh arrays (views of that step's
buffer), not views of a live state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.state import Action, EnvState, init_state, I8, I32
from ..ops.step_kernel import complete_step
from ..ops.table import OpTable

_GRIDS = ("input", "grid", "selected", "clip", "object", "object_sel",
          "background")
_DIMS = ("input_dim", "grid_dim", "clip_dim", "object_dim", "object_pos")
_FLAGS = ("trials_remain", "terminated", "active", "rotation_parity")
_WORDS = ("steps", "submit_count", "last_reward")     # 4 bytes each


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain transition on the CPU")
    return dev


class TorchEngine:
    """A single env stepped by the batched engine's step at B=1."""

    def __init__(self, table: OpTable, H: int = 30, W: int = 30,
                 max_trial: int = -1, device="cuda"):
        self.table = table
        self.H, self.W = H, W
        self.max_trial = max_trial
        self.device = _device(device)
        self.state: EnvState = None
        self._host: Dict[str, np.ndarray] = {}
        self._submit_count = self._steps = 0
        self._reward = 0.0

    @property
    def n_ops(self) -> int:
        return self.table.n_ops

    @property
    def submit_count(self) -> int:
        return self._submit_count

    def reset(self, input_grid: np.ndarray, answer: np.ndarray,
              reset_on_submit: bool = False) -> None:
        def padded(g):
            out = np.zeros((1, self.H, self.W), np.int8)
            out[0, :g.shape[0], :g.shape[1]] = g
            return torch.from_numpy(out).to(self.device)

        dims = lambda g: torch.tensor([g.shape], dtype=I8, device=self.device)
        inp, ans = np.asarray(input_grid), np.asarray(answer)
        self.state = init_state(padded(inp), dims(inp), padded(ans),
                                dims(ans), max_trial=self.max_trial,
                                reset_on_submit=int(reset_on_submit))
        self._read_back()

    def _upload(self, selections: np.ndarray, ops: np.ndarray) -> Action:
        """``n`` selections and ops in one host-to-device copy: the ops as
        int32 words first, then the selections."""
        n = len(ops)
        buf = np.empty(4 * n + n * self.H * self.W, np.int8)
        buf[:4 * n].view(np.int32)[:] = ops
        buf[4 * n:] = np.asarray(selections, np.int8).reshape(-1)
        dev = torch.from_numpy(buf).to(self.device)
        return Action(selection=dev[4 * n:].view(n, self.H, self.W),
                      operation=dev[:4 * n].view(I32))

    def step(self, selection: np.ndarray, operation: int
             ) -> Tuple[float, bool]:
        """One transition; returns ``(reward, terminated)``."""
        sel = np.asarray(selection)
        if sel.size != self.H * self.W:
            raise ValueError(f"selection of shape {sel.shape} for a "
                             f"{self.H}x{self.W} engine")
        act = self._upload(sel, np.array([operation], np.int32))
        self.state, _, _ = complete_step(self.state, act, self.table)
        self._read_back()
        return self._reward, bool(self._host["terminated"][0])

    def run(self, selections: np.ndarray, operations: np.ndarray):
        """Step a whole action sequence with one copy each way; returns
        ``(rewards f32 [n], terminated bool [n])``."""
        n = len(operations)
        acts = self._upload(np.asarray(selections).reshape(
            n, self.H, self.W), np.asarray(operations, np.int32))
        rewards, terms = [], []
        for i in range(n):
            act = Action(selection=acts.selection[i:i + 1],
                         operation=acts.operation[i:i + 1])
            self.state, _, _ = complete_step(self.state, act, self.table)
            rewards.append(self.state.last_reward)
            terms.append(self.state.terminated)
        if not n:
            return np.zeros(0, np.float32), np.zeros(0, bool)
        out = self._read_back(torch.cat(rewards).view(I8),
                              torch.cat(terms))
        return out[:4 * n].view(np.float32).copy(), out[4 * n:] != 0

    def _read_back(self, *extra: torch.Tensor) -> np.ndarray:
        """Pack every observed field (and ``extra`` int8 tensors in front)
        into one int8 buffer on the device, copy it to the host once, and
        keep numpy views of it.  Returns the ``extra`` bytes."""
        st = self.state
        parts = list(extra) + \
            [getattr(st, k).reshape(-1).view(I8) for k in _WORDS] + \
            [getattr(st, k).reshape(-1) for k in _FLAGS + _DIMS + _GRIDS]
        buf = torch.cat(parts).cpu().numpy()
        at = sum(int(t.numel()) for t in extra)
        out = buf[:at]
        self._steps = int(buf[at:at + 4].view(np.int32)[0])
        self._submit_count = int(buf[at + 4:at + 8].view(np.int32)[0])
        self._reward = float(buf[at + 8:at + 12].view(np.float32)[0])
        at += 12
        host = {}
        for k in _FLAGS:
            host[k] = buf[at:at + 1]
            at += 1
        for k in _DIMS:
            host[k] = buf[at:at + 2]
            at += 2
        P = self.H * self.W
        for k in _GRIDS:
            host[k] = buf[at:at + P].reshape(self.H, self.W)
            at += P
        self._host = host
        return out

    def observation(self, keys=()) -> dict:
        """The observation dict in the reference layout; ``keys``: include
        the "clip" and "selected" groups.  Fresh arrays of the last step's
        read-back."""
        h = self._host
        obs = {k: h[k] for k in ("trials_remain", "terminated", "input",
                                 "input_dim", "grid", "grid_dim")}
        if "clip" in keys:
            obs["clip"], obs["clip_dim"] = h["clip"], h["clip_dim"]
        if "selected" in keys:
            obs["selected"] = h["selected"]
            obs["object_states"] = {
                k: h[k] for k in ("active", "object", "object_sel",
                                  "object_dim", "object_pos", "background",
                                  "rotation_parity")}
        return obs

    def state_dict(self) -> dict:
        """Snapshot in the oracle's state layout."""
        obs = self.observation(("clip", "selected"))
        d = {k: v.copy() for k, v in obs.items() if k != "object_states"}
        d["object_states"] = {k: v.copy()
                              for k, v in obs["object_states"].items()}
        d["_submit_count"] = self._submit_count
        d["_steps"] = self._steps
        return d


__all__ = ["TorchEngine"]

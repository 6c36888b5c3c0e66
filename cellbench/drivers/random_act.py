"""The engine under random actions: the unit of work is one segment of
``segment_steps`` lockstep steps of ``n_envs`` envs with auto-reset, each
step's action drawn by the benchmark (a uniform op and two uniform bbox
corners per env, as ``envs/rollout.py::random_bbox_actions`` draws them),
no policy and no learner.

The actions of segment ``s`` come from a generator seeded by the run's
seed and ``s``, so the reference draws them again.  Set-up runs one
segment from the reset, which the reference follows from the reset; in
the window, ``checked_segments`` segments drawn from the seed among the
first ``checked_from`` keep their start and end states and their rewards
and flags for it."""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict

import torch

from cellbench import harness as H
from cellbench.kinds import mix
from cellbench.reference import engine as E
from cellbench.reference.compare import state_rows_differ

WARM = -1


def draw_actions(gen: torch.Generator, B: int, n_ops: int, H_: int, W: int,
                 device):
    """Uniform ops and two uniform corners per env: ``(ops, corners)``."""
    ops = torch.randint(0, n_ops, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    corners = torch.randint(0, H_, (4, B), generator=gen, device=device,
                            dtype=torch.int32)
    return ops, corners


def to_action(ops, corners, H_: int, W: int, action_cls):
    sel = E.geometry.bbox_selection(corners[0], corners[1], corners[2],
                                    corners[3], H_, W)
    return action_cls(selection=sel, operation=ops)


class EngineCell:
    def __init__(self, spec: dict, seed: int, device, spans: H.Spans):
        from arcle_tpu_torch.core.state import Action
        self.spec, self.seed, self.device, self.spans = \
            spec, seed, device, spans
        cfg, tr = spec["config"], spec["traffic"]
        self.K = H.kind(cfg["kind"])
        self.B, self.steps = tr["n_envs"], tr["segment_steps"]
        self.env, bs = self.K.program_env(cfg, self.B, seed, device)
        self.Action = Action
        self.n_ops = self.env.table.n_ops
        self.hw = tuple(bs.env.grid.shape[-2:])
        self.gen = torch.Generator(device=device)
        rng = random.Random(mix(seed, 4))
        self.checked = set(rng.sample(range(tr["checked_from"]),
                                      tr["checked_segments"]))
        self.start_pool = bs.pool
        self.reset_state = bs.env
        self.bs = bs
        self.segments: Dict[int, dict] = {}
        self._segment(WARM, True)
        self.failed = 0
        self.bytes_per_env_step = None

    def _segment(self, s: int, keep: bool) -> None:
        H_, W = self.hw
        self.gen.manual_seed(mix(self.seed, 1000 + s))
        spans, B = self.spans, self.B
        if keep:
            rec = {"start": self.bs,
                   "rewards": torch.empty((self.steps, B),
                                          device=self.device),
                   "term": torch.empty((self.steps, B), dtype=torch.bool,
                                       device=self.device),
                   "trunc": torch.empty((self.steps, B), dtype=torch.bool,
                                        device=self.device)}
        for t in range(self.steps):
            t0 = time.perf_counter_ns() if spans.on else 0
            act = to_action(*draw_actions(self.gen, B, self.n_ops, H_, W,
                                          self.device), H_, W, self.Action)
            t1 = time.perf_counter_ns() if spans.on else 0
            self.bs, _, rew, term, trunc = self.env.step(self.bs, act)
            if spans.on:
                t2 = time.perf_counter_ns()
                spans.add("draw actions", t0, t1)
                spans.add("env.step", t1, t2)
            if keep:
                rec["rewards"][t].copy_(rew)
                rec["term"][t].copy_(term)
                rec["trunc"][t].copy_(trunc)
        if keep:
            rec["end"] = self.bs
            self.segments[s] = rec

    def unit(self, i: int) -> None:
        self._segment(i, i in self.checked)

    def after_window(self) -> None:
        pass

    def release(self) -> None:
        del self.env, self.bs

    def end_to_end(self, units: int, window_s: float) -> Dict[str, float]:
        return {"engine_env_steps_per_s":
                units * self.B * self.steps / window_s}

    def layer_context(self, units: int, window_s: float) -> dict:
        return {"env_steps": units * self.B * self.steps, "kind": "engine"}

    def phases(self, tr: H.Trace):
        off = tr.kernels[0][1] - tr.host_marker_ns if tr.kernels else 0
        return sorted((label, a + off, b + off)
                      for label, a, b in self.spans.items)

    # ---- correctness -----------------------------------------------------
    def reference(self, reward_dtype=torch.float32) -> dict:
        """Replay every kept segment; returns the replayed rewards, flags
        and end states, the rows that are no fresh episode of the bank,
        and the step kernel's bytes per env-step over these steps."""
        from cellbench.cost.step_kernel_bytes import step_kernel_bytes
        cfg = self.spec["config"]
        spec = self.K.env_spec(cfg)
        bank = self.K.bank(cfg, self.seed)
        st = self.reset_state
        bad = int((~torch.as_tensor(bank.members(
            st.input, st.input_dim, st.answer, st.answer_dim))).sum())
        ref_init = E.init_state(st.input, st.input_dim, st.answer,
                                st.answer_dim, max_trial=spec.max_trial)
        bad += state_rows_differ(ref_init, st)
        p = self.start_pool
        pool = (p.grid, p.dim, p.answer, p.answer_dim)
        bad += int((~torch.as_tensor(bank.members(*pool))).sum())
        H_, W = self.hw
        out, nbytes, nsteps = {}, 0, 0
        for s, rec in sorted(self.segments.items()):
            st = rec["start"].env
            counter = rec["start"].pool.counter.long()
            gen = torch.Generator(device=self.device).manual_seed(
                mix(self.seed, 1000 + s))
            r = {k: torch.empty_like(rec[k]) for k in ("rewards", "term",
                                                      "trunc")}
            for t in range(self.steps):
                ops, corners = draw_actions(gen, self.B, self.n_ops, H_, W,
                                            self.device)
                act = to_action(ops, corners, H_, W, E.Action)
                nbytes += step_kernel_bytes(st, act, spec.table)
                nsteps += self.B
                s2, rew, term, trunc = E.env_step(spec, st, act,
                                                  reward_dtype)
                done = term | trunc
                fresh = E.fresh_from_pool(pool, counter, spec.max_trial,
                                          s2.reset_on_submit)
                counter = counter + done.long()
                st = E.merge_done(done, fresh, s2)
                r["rewards"][t], r["term"][t], r["trunc"][t] = rew, term, \
                    trunc
            r["end"] = st
            r["counter"] = counter
            out[s] = r
        self.bytes_per_env_step = nbytes / max(nsteps, 1)
        return {"segments": out, "bad": bad}

    def compare(self, ref: dict) -> Dict[str, float]:
        rows = ref["bad"]
        for s, r in ref["segments"].items():
            rec = self.segments[s]
            for k in ("rewards", "term", "trunc"):
                rows += int((rec[k] != r[k]).sum())
            rows += state_rows_differ(rec["end"].env, r["end"])
            rows += int((rec["end"].pool.counter.long()
                         != r["counter"]).sum())
        return {"transitions": float(rows)}

    def check(self) -> Dict[str, float]:
        return self.compare(self.reference())


def setup(spec: dict, seed: int, device, spans: H.Spans) -> EngineCell:
    return EngineCell(spec, seed, device, spans)

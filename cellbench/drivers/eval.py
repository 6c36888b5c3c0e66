"""Evaluation of a policy, as ``benchmarks/eval_answer_given.py::
evaluate`` runs it: the unit of work is one batch of ``n_envs`` fresh
episodes of ``episode_steps`` steps without auto-reset, greedy and
sampling batches in turn, through the agent's ``sample_fn`` and
``BatchedEnv.step``.

Batch ``i`` resets and draws from generators seeded by the run's seed and
``i``.  ``checked_batches`` batches drawn from the seed among the first
``checked_from`` keep their start state, their actions, log-probs,
rewards and flags and their end state; the reference follows each from
its reset."""

from __future__ import annotations

import random
import time
from typing import Dict

import torch

from cellbench import harness as H
from cellbench.kinds import draw_weights, mix
from cellbench.reference import engine as E
from cellbench.reference.compare import state_rows_differ


class EvalCell:
    def __init__(self, spec: dict, seed: int, device, spans: H.Spans):
        from arcle_tpu_torch.training.rollout import decode_bbox_actions
        self.decode = decode_bbox_actions
        self.spec, self.seed, self.device, self.spans = \
            spec, seed, device, spans
        cfg, tr = spec["config"], spec["traffic"]
        self.K = H.kind(cfg["kind"])
        self.B, self.steps = tr["n_envs"], tr["episode_steps"]
        self.modes = tr["modes"]
        self.size = cfg["env"]["size"]
        self.model, self.agent, self.env = self.K.program_eval(
            cfg, tr, seed, device)
        self.weights = draw_weights(self.K.param_specs(cfg), seed, device)
        self.model.load_state_dict(self.weights, strict=True)
        self.gen = torch.Generator(device=device)
        self.act_gen = torch.Generator(device=device)
        rng = random.Random(mix(seed, 5))
        n_modes = len(self.modes)
        per_mode = tr["checked_batches"] // n_modes
        self.checked = set()
        for m in range(n_modes):
            idx = [i for i in range(tr["checked_from"]) if i % n_modes == m]
            self.checked.update(rng.sample(idx, per_mode))
        self.batches: Dict[int, dict] = {}
        self.lens = []
        with torch.no_grad():
            for w in range(n_modes):         # warm-up: every mode once
                self._batch(-1 - w, False, w)
        self.lens = []
        self.failed = 0

    def _batch(self, i: int, keep: bool, mode: int = None) -> None:
        mode = i % len(self.modes) if mode is None else mode
        det = self.modes[mode] == "deterministic"
        spans, B = self.spans, self.B
        dev = self.device
        self.gen.manual_seed(mix(self.seed, 2000 + i))
        self.act_gen.manual_seed(mix(self.seed, 3000 + i))
        t0 = time.perf_counter_ns() if spans.on else 0
        b = self.env.reset(self.gen, B)
        if spans.on:
            spans.add("reset", t0, time.perf_counter_ns())
        solved = torch.zeros(B, dtype=torch.bool, device=dev)
        lens = torch.full((B,), self.steps, dtype=torch.int32, device=dev)
        rec = {"start": b.env, "det": det, "acts": [], "lp": [],
               "rewards": [], "term": []} if keep else None
        for t in range(self.steps):
            t0 = time.perf_counter_ns() if spans.on else 0
            acts, lp, _ = self.agent.sample_fn(
                self.model, self.agent.obs_fn(b.env), self.act_gen, det)
            t1 = time.perf_counter_ns() if spans.on else 0
            b, _, rew, term, _ = self.env.step(
                b, self.decode(acts, self.size, self.size))
            lens = torch.where(term & ~solved, lens.clamp(max=t + 1), lens)
            solved |= term
            if spans.on:
                t2 = time.perf_counter_ns()
                spans.add("policy sample_fn", t0, t1)
                spans.add("env.step", t1, t2)
            if keep:
                for k, v in (("acts", acts), ("lp", lp), ("rewards", rew),
                             ("term", term)):
                    rec[k].append(v)
        if keep:
            rec["end"] = b.env
            self.batches[i] = rec
        self.lens.append(lens)

    def unit(self, i: int) -> None:
        with torch.no_grad():
            self._batch(i, i in self.checked)

    def after_window(self) -> None:
        self.live = sum(int(x.sum()) for x in self.lens)

    def release(self) -> None:
        del self.model, self.agent, self.env

    def end_to_end(self, units: int, window_s: float) -> Dict[str, float]:
        return {"eval_env_steps_per_s": self.live / window_s}

    def layer_context(self, units: int, window_s: float) -> dict:
        from cellbench.cost import flops
        f = flops.of(self.spec["config"])
        return {"model_flops": self.live * f["greedy"],
                "peak": self.spec["config"]["precision"]["mfu_peak"],
                "kind": "eval"}

    def phases(self, tr: H.Trace):
        off = tr.kernels[0][1] - tr.host_marker_ns if tr.kernels else 0
        return sorted((label, a + off, b + off)
                      for label, a, b in self.spans.items)

    # ---- correctness -----------------------------------------------------
    def reference(self, prec: str = "fp32") -> dict:
        """Replay every kept batch from its reset with the actions taken:
        per step the reference's log-probs of those actions, the gap of
        each greedy action below the reference's best, the rewards and
        flags, and the end state."""
        cfg = self.spec["config"]
        policy = self.K.policy_ref(cfg)
        spec = self.K.env_spec(cfg, episode_limit=self.steps)
        bank = self.K.bank(cfg, self.seed,
                           n_tasks=self.spec["traffic"]["n_tasks"])
        out = {}
        for i, rec in sorted(self.batches.items()):
            st = rec["start"]
            bad = int((~torch.as_tensor(bank.members(
                st.input, st.input_dim, st.answer, st.answer_dim))).sum())
            bad += state_rows_differ(E.init_state(
                st.input, st.input_dim, st.answer, st.answer_dim,
                max_trial=spec.max_trial), st)
            r = {"lp": [], "gap": [], "rewards": [], "term": [], "bad": bad}
            for t, acts in enumerate(rec["acts"]):
                obs = policy.observe(st)
                with torch.no_grad():
                    lop, lbb, _ = policy.dists(self.weights, obs, acts, prec)
                    lp, _, _ = policy.evaluate(self.weights, obs, acts, prec)
                chosen_op = lop.gather(-1, acts[:, 4:5].long())[:, 0]
                chosen_bb = lbb.gather(-1, acts[:, :4].long()[..., None])[
                    ..., 0]
                gap = torch.maximum(lop.max(-1).values - chosen_op,
                                    (lbb.max(-1).values - chosen_bb).max(-1)
                                    .values)
                s2, rew, term, trunc = E.env_step(
                    spec, st, E.bbox_actions(acts, self.size, self.size))
                r["lp"].append(lp)
                r["gap"].append(gap)
                r["rewards"].append(rew)
                r["term"].append(term)
                st = s2
            r["end"] = st
            out[i] = r
        return out

    def compare(self, cand_lp, ref: dict) -> Dict[str, float]:
        """``cand_lp(i, t)``: the log-prob the candidate gave the action
        of step ``t`` of batch ``i``."""
        rows, argmax_gap, lp_gap = 0, 0.0, 0.0
        for i, r in ref.items():
            rec = self.batches[i]
            rows += r["bad"]
            for t in range(len(rec["acts"])):
                rows += int((rec["rewards"][t] != r["rewards"][t]).sum())
                rows += int((rec["term"][t] != r["term"][t]).sum())
                if rec["det"]:
                    argmax_gap = max(argmax_gap, float(r["gap"][t].max()))
                else:
                    lp_gap = max(lp_gap, float(
                        (cand_lp(i, t) - r["lp"][t]).abs().max().detach()))
            rows += state_rows_differ(rec["end"], r["end"])
        return {"transitions": float(rows), "argmax_gap": argmax_gap,
                "logp_gap": lp_gap}

    def check(self) -> Dict[str, float]:
        ref = self.reference()
        return self.compare(lambda i, t: self.batches[i]["lp"][t], ref)


def setup(spec: dict, seed: int, device, spans: H.Spans) -> EvalCell:
    return EvalCell(spec, seed, device, spans)

"""PPO training: the unit of work is one iteration of the port's trainer
(a rollout of ``rollout_steps`` lockstep steps of ``n_envs`` envs, the
learner batch and the update).

Set-up builds the trainer from the seed, loads the benchmark's weights
and drives the first ``checked_iterations`` iterations through the same
call the window makes; what they take in and give out is kept for the
reference, which follows them after the window.  In the window, one
iteration drawn from the seed among the first ``checked_from`` keeps the
same record, with the trainer's parameters and Adam's state at its
start: the reference follows it from there."""

from __future__ import annotations

import math
import random
from contextlib import contextmanager
from typing import Dict, List

import torch

from cellbench import harness as H
from cellbench.kinds import draw_weights, mix
from cellbench.reference import compare
from cellbench.reference.ppo import digest, follow

WINDOW_NUMBERS = ("logp_gap", "value_gap", "loss_gap_update1", "update_gap",
                  "update_gap_median")


@contextmanager
def recorded(perms: List, losses: List):
    """Keep the minibatch shuffles the port's learner draws from its own
    generator (the reference follows them, and checks each is a
    permutation of every row) and each update's loss."""
    from arcle_tpu_torch.training import ppo as port_ppo
    orig_perms, orig_update = port_ppo.permutations, port_ppo._update

    def recording_perms(*a, **kw):
        out = orig_perms(*a, **kw)
        perms.append([q.clone() for q in out])
        return out

    def recording_update(*a, **kw):
        stats = orig_update(*a, **kw)
        losses.append(stats["total_loss"])
        return stats

    port_ppo.permutations = recording_perms
    port_ppo._update = recording_update
    try:
        yield
    finally:
        port_ppo.permutations = orig_perms
        port_ppo._update = orig_update


class PPOCell:
    def __init__(self, spec: dict, seed: int, device, spans: H.Spans):
        self.spec, self.seed, self.device = spec, seed, device
        cfg, tr = spec["config"], spec["traffic"]
        self.K = H.kind(cfg["kind"])
        self.L = cfg["learner"]
        self.n_envs, self.T = tr["n_envs"], tr["rollout_steps"]
        self.run, self.iterate = self.K.program_ppo(cfg, tr, seed, device)
        self.weights = draw_weights(self.K.param_specs(cfg), seed, device)
        params = self.run.params
        params.load_state_dict(self.weights, strict=True)
        names = {p: n for n, p in params.named_parameters()}
        b1 = self.L["adam"][0]
        first: Dict[str, torch.Tensor] = {}

        def after_first_step(opt, args, kwargs):
            if not first:
                for p, st in opt.state.items():
                    first[names[p]] = st["exp_avg"].detach().clone() / (1 - b1)

        hook = self.run.opt.register_step_post_hook(after_first_step)
        self.digest_w = None
        if self.K.DIGEST_OBS:
            g = torch.Generator(device=device).manual_seed(mix(seed, 3))
            D = self.run.agent.obs_dim
            self.digest_w = torch.randint(1, 1 << 20, (D,), generator=g,
                                          device=device, dtype=torch.int64)
        rec = {"start": self.run.bs.env, "iters": []}
        for _ in range(tr["checked_iterations"]):
            perms: List = []
            losses: List = []
            with recorded(perms, losses):
                traj, stats, _ = self.iterate()
            rec["iters"].append(self._record(traj, stats, perms, losses))
            del traj
            if len(rec["iters"]) == 1:
                rec["params_after_1"] = {
                    n: p.detach().clone() for n, p in params.named_parameters()}
        hook.remove()
        rec["final"] = self.run.bs.env
        rec["first_grads"] = first
        rec["params_after"] = {n: p.detach().clone()
                               for n, p in params.named_parameters()}
        self.rec = rec
        self.checked = {random.Random(mix(seed, 4)).randrange(
            tr["checked_from"])}
        self.win = None
        self.marks, self.losses, self.dones, self.terms = [], [], [], []
        self.failed = 0

    def _record(self, traj, stats, perms, losses) -> dict:
        it = {k: getattr(traj, k) for k in (
            "actions", "log_probs", "values", "rewards", "dones",
            "terminated", "final_values")}
        if self.digest_w is not None:
            it["obs_digest"] = torch.stack([digest(traj.obs[t], self.digest_w)
                                            for t in range(self.T)])
        else:
            it["obs"] = traj.obs
        pool = self.run.bs.pool
        it["pool"] = None if pool is None else (
            pool.grid, pool.dim, pool.answer, pool.answer_dim)
        it["perms"] = perms[0] if perms else None
        it["loss"] = stats["total_loss"]
        it["update_losses"] = losses
        return it

    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone()
                for n, p in self.run.params.named_parameters()}

    def _adam(self) -> tuple:
        """Adam's ``(m, v, t)`` by parameter name, as the port holds it."""
        opt, m, v, t = self.run.opt, {}, {}, 0
        for n, p in self.run.params.named_parameters():
            st = opt.state.get(p)
            if st:
                m[n] = st["exp_avg"].detach().clone()
                v[n] = st["exp_avg_sq"].detach().clone()
                t = int(st["step"])
        return m, v, t

    # ---- the window ------------------------------------------------------
    def unit(self, i: int) -> None:
        if i in self.checked:
            win = {"start": self.run.bs.env, "params_start": self._params(),
                   "adam": self._adam()}
            perms: List = []
            losses: List = []
            with recorded(perms, losses):
                traj, stats, marks = self.iterate()
            win["iters"] = [self._record(traj, stats, perms, losses)]
            win["final"] = self.run.bs.env
            win["params_after"] = self._params()
            self.win = win
        else:
            traj, stats, marks = self.iterate()
        self.marks.append(marks)
        self.losses.append(stats["total_loss"])
        self.dones.append(traj.dones)
        self.terms.append(traj.terminated)

    def after_window(self) -> None:
        self.split_ms = [m.ms() for m in self.marks]
        self.failed = sum(not torch.isfinite(x).item() for x in self.losses)
        self.n_boot = sum(int((d & ~t).sum())
                          for d, t in zip(self.dones, self.terms))

    def release(self) -> None:
        del self.run, self.iterate, self.dones, self.terms, self.marks
        for it in self.rec["iters"] + (self.win["iters"] if self.win
                                       else []):
            it["loss"] = float(it["loss"])
            it["update_losses"] = [float(x) for x in it["update_losses"]]

    def end_to_end(self, units: int, window_s: float) -> Dict[str, float]:
        return {"train_env_steps_per_s":
                units * self.n_envs * self.T / window_s}

    # ---- the per-layer context -------------------------------------------
    def layer_context(self, units: int, window_s: float) -> dict:
        from cellbench.cost import flops
        f = flops.of(self.spec["config"])
        L = self.L
        rows = self.n_envs * self.T
        mb = rows // L["n_minibatches"]
        model_flops = units * (rows * f["act"] + self.n_envs * f["value"]
                               + L["n_epochs"] * L["n_minibatches"] * mb
                               * f["update_row"]) + self.n_boot * f["value"]
        return {"split_ms": self.split_ms, "T": self.T, "units": units,
                "model_flops": model_flops,
                "peak": self.spec["config"]["precision"]["mfu_peak"],
                "kind": "train"}

    def phases(self, tr: H.Trace):
        """Rollout and update of each iteration on the trace's clock, from
        the CUDA events the iteration returns."""
        out, ev0, o = [], tr.start_event, tr.origin_ns
        if ev0 is None:
            return out
        at = lambda e: o + int(ev0.elapsed_time(e) * 1e6)
        for m in self.marks:
            a, b, c = m.marks
            out.append(("rollout", at(a), at(b)))
            out.append(("update", at(b), at(c)))
        return out

    # ---- correctness -----------------------------------------------------
    def reference(self, prec: str = "fp32", fault: str = "none") -> dict:
        """The set-up's iterations from the benchmark's weights, and the
        window's checked iteration from the port's parameters and Adam
        state at its start."""
        cfg = self.spec["config"]
        bank = self.K.bank(cfg, self.seed)
        args = (self.K.policy_ref(cfg), self.K.env_spec(cfg), self.L,
                self.L["entropy_coeff"], bank, self.digest_w)
        out = {"setup": follow(self.rec, self.weights, *args, prec=prec,
                               fault=fault)}
        if self.win is not None:
            out["window"] = follow(self.win, self.win["params_start"], *args,
                                   prec=prec, fault=fault,
                                   adam=self.win["adam"])
        return out

    def compare(self, cand: dict, ref: dict, detail: bool = False
                ) -> Dict[str, float]:
        """The numbers of the set-up's iterations, and those of the
        window's with ``_window`` after their names (not a number where
        the window never reached its checked iteration)."""
        out = compare.ppo(cand["setup"], ref["setup"], self.weights, detail)
        if self.win is None:
            out.update({f"{k}_window": math.nan for k in WINDOW_NUMBERS})
            return out
        w = compare.ppo(cand["window"], ref["window"],
                        self.win["params_start"], detail)
        out["transitions"] += w["transitions"]
        out.update({f"{k}_window": w[k] for k in WINDOW_NUMBERS})
        if detail:
            out["detail"]["window"] = {
                "update_loss_gaps_first": w["detail"][
                    "update_loss_gaps_first"],
                "iteration": sorted(self.checked)[0]}
        return out

    def check(self) -> Dict[str, float]:
        return self.compare({"setup": self.rec, "window": self.win},
                            self.reference())


def setup(spec: dict, seed: int, device, spans: H.Spans) -> PPOCell:
    return PPOCell(spec, seed, device, spans)

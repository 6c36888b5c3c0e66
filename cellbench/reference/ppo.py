"""PPO in plain PyTorch, and the replay of a training run's first
iterations.

:func:`follow` takes the inputs of a run (the start state, the weights, and
per iteration the actions taken, the reset pool or the auto-reset rows and
the minibatch shuffles) and works out everything the port's iteration
produces from them: every transition, the log-probs and values of the
actions taken, the TimeLimit bootstrap values, the learner batch (GAE,
normalised advantages, the auxiliary targets), each update's loss, the
first optimizer step's gradient and the parameters after the last update.

The loss is the clipped surrogate + clipped value loss - entropy bonus +
KL penalty (+ the three auxiliary losses); the gradient is clipped by its
global norm as ``optax.clip_by_global_norm`` clips (only above the limit,
by ``limit / norm``); the optimizer is Adam with bias correction.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import engine as E


def gae(rewards, values, dones, final_values, last_value, gamma, lam):
    """Advantages and returns over ``[T, B]``; the chain is cut at every
    done, and a truncated step bootstraps with its final value."""
    T = rewards.shape[0]
    advs = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in reversed(range(T)):
        noncut = 1.0 - dones[t].float()
        delta = rewards[t] + gamma * (v_next * noncut + final_values[t]) \
            - values[t]
        adv_next = delta + gamma * lam * noncut * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


def make_batch(traj: Dict[str, torch.Tensor], last_value, L: dict,
               size: Optional[int]) -> Dict[str, torch.Tensor]:
    """The flattened learner batch of one rollout."""
    rewards = traj["rewards"]
    if L.get("potential_shaping"):
        from .gpt import potential
        phi = potential(traj["obs"], size, size)
        term = traj["terminated"].float()
        rewards = rewards * (1.0 + L["gamma"] * (1.0 - term)) - phi
    fv = traj["final_values"] if L["bootstrap_truncation"] \
        else torch.zeros_like(traj["values"])
    adv, ret = gae(rewards, traj["values"], traj["dones"], fv, last_value,
                   L["gamma"], L["gae_lambda"])
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    batch = {"obs": flat(traj["obs"]), "actions": flat(traj["actions"]),
             "log_probs": flat(traj["log_probs"]),
             "values": flat(traj["values"]), "advantages": flat(adv),
             "returns": flat(ret)}
    if L.get("aux_coeff", 0.0) > 0.0:
        done = traj["dones"].float()
        raw = traj["rewards"]
        prev = torch.cat([torch.zeros_like(raw[:1]),
                          raw[:-1] * (1.0 - done[:-1])], 0)
        P = size * size
        nxt = torch.cat([traj["obs"][1:, :, :P], traj["obs"][-1:, :, :P]],
                        0)
        valid = torch.cat([1.0 - done[:-1], torch.zeros_like(raw[-1:])], 0)
        batch.update(rewards=flat(raw), prev_rewards=flat(prev),
                     next_grid=flat(nxt), aux_valid=flat(valid))
    return batch


def ppo_loss(policy, p, b, L: dict, ent_coeff: float, prec: str):
    lp, value, ent = policy.evaluate(p, b["obs"], b["actions"], prec)
    ratio = torch.exp(lp - b["log_probs"])
    adv = b["advantages"]
    eps = L["clip_eps"]
    policy_loss = -torch.minimum(ratio * adv,
                                 torch.clamp(ratio, 1 - eps, 1 + eps) * adv
                                 ).mean()
    err = (value - b["returns"]) ** 2
    clipped = (b["values"] + torch.clamp(value - b["values"], -L["vf_clip"],
                                         L["vf_clip"]) - b["returns"]) ** 2
    vf_loss = 0.5 * torch.maximum(err, clipped).mean()
    kl = (b["log_probs"] - lp).mean()
    total = policy_loss + L["vf_coeff"] * vf_loss - ent_coeff * ent.mean() \
        + L["kl_coeff"] * kl
    if L.get("aux_coeff", 0.0) > 0.0:
        aux = policy.aux(p, b["obs"], b["actions"], prec)
        rtm1 = ((aux["rtm1"] - b["prev_rewards"]) ** 2).mean()
        r = ((aux["r"] - b["rewards"]) ** 2).mean()
        g_logp = F.log_softmax(aux["g_logits"], -1)
        tgt = b["next_grid"].long().clamp(0, g_logp.shape[-1] - 1)
        ce = -g_logp.gather(-1, tgt[..., None])[..., 0]
        denom = torch.clamp(b["aux_valid"].sum(), min=1.0)
        g = (ce.mean(-1) * b["aux_valid"]).sum() / denom
        terms = {"rtm1": rtm1, "rtm1+rt": rtm1 + r, "all": rtm1 + r + g}
        total = total + L["aux_coeff"] * terms[L["aux_terms"]]
    return total


class Learner:
    """The policy's parameters and Adam's state, in float32."""

    def __init__(self, weights: Dict[str, torch.Tensor], L: dict,
                 adam: Optional[tuple] = None):
        """``adam``: Adam's ``(m, v, t)`` to start from (a run's state
        after ``t`` steps); fresh where None."""
        self.p = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in weights.items()}
        self.L = L
        self.b1, self.b2, self.eps = L["adam"]
        m, v, self.t = adam if adam is not None else ({}, {}, 0)
        self.m = {k: m[k].clone() if k in m else torch.zeros_like(x)
                  for k, x in self.p.items()}
        self.v = {k: v[k].clone() if k in v else torch.zeros_like(x)
                  for k, x in self.p.items()}
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.losses: List[float] = []

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.p.items()}

    def update(self, policy, b, ent_coeff: float, prec: str,
               fault: str) -> float:
        if fault == "half_batch":
            n = b["obs"].shape[0] // 2
            b = {k: v[:n] for k, v in b.items()}
        loss = ppo_loss(policy, self.p, b, self.L, ent_coeff, prec)
        names = list(self.p)
        grads = torch.autograd.grad(loss, [self.p[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(self.p[k]) if g is None else g
                 for k, g in zip(names, grads)}
        limit = self.L["max_grad_norm"]
        if limit > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if float(norm) >= limit:
                grads = {k: g / norm * limit for k, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = {k: g.clone() for k, g in grads.items()}
        self.t += 1
        lr = self.L["lr"]
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
                mh = self.m[k] / (1 - self.b1 ** self.t)
                vh = self.v[k] / (1 - self.b2 ** self.t)
                self.p[k] -= lr * mh / (torch.sqrt(vh) + self.eps)
        self.losses.append(float(loss.detach()))
        return self.losses[-1]

    def train(self, policy, batch, perms, ent_coeff, prec, fault) -> float:
        """``n_epochs`` x ``n_minibatches`` updates; the mean loss."""
        L = self.L
        if L["n_epochs"] == 1 and L["n_minibatches"] == 1:
            return self.update(policy, batch, ent_coeff, prec, fault)
        n = batch["obs"].shape[0]
        mb = max(1, n // L["n_minibatches"])
        losses = []
        for perm in perms:
            for i in range(L["n_minibatches"]):
                rows = perm[i * mb:(i + 1) * mb]
                losses.append(self.update(
                    policy, {k: v[rows] for k, v in batch.items()},
                    ent_coeff, prec, fault))
        return float(np.mean(losses))


def digest(obs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """int64 ``[B]``: a position-weighted sum of each observation row, the
    same whoever computes it, that differs where a cell differs."""
    return (obs.to(torch.int64) * weights).sum(-1)


def follow(rec: dict, weights: Dict[str, torch.Tensor], policy, spec,
           L: dict, ent_coeff: float, bank, digest_w=None,
           prec: str = "fp32", fault: str = "none",
           adam: Optional[tuple] = None) -> dict:
    """Replay ``rec``'s checked iterations from ``weights`` (and Adam's
    state ``adam``, fresh where None): returns the outputs the port
    recorded, worked out again, each update's loss, and ``resets_bad``:
    the start and reset rows that are not fresh episodes of the bank."""
    learner = Learner(weights, L, adam)
    st = rec["start"]
    resets_bad = int((~torch.as_tensor(bank.members(
        st.input, st.input_dim, st.answer, st.answer_dim))).sum())
    H, W = st.grid.shape[-2:]
    size = H if L.get("potential_shaping") or L.get("aux_coeff", 0) else None
    iters_out = []
    n_it = len(rec["iters"])
    for i, it in enumerate(rec["iters"]):
        acts_all = it["actions"]
        T, B = acts_all.shape[:2]
        pool = it.get("pool")
        if pool is not None:
            resets_bad += int((~torch.as_tensor(bank.members(*pool))).sum())
            counter = torch.zeros(B, dtype=torch.int64, device=st.grid.device)
        obs_buf = torch.empty((T, B, policy.observe(st).shape[1]),
                              dtype=torch.int8, device=st.grid.device)
        out = {k: torch.zeros((T, B), device=st.grid.device)
               for k in ("log_probs", "values", "rewards", "final_values")}
        out["dones"] = torch.zeros((T, B), dtype=torch.bool,
                                   device=st.grid.device)
        out["terminated"] = torch.zeros_like(out["dones"])
        out["need"] = torch.zeros_like(out["dones"])
        p = learner.params()
        for t in range(T):
            obs = policy.observe(st)
            obs_buf[t] = obs
            acts = acts_all[t]
            with torch.no_grad():
                lp, v, _ = policy.evaluate(p, obs, acts, prec)
            s2, rew, term, trunc = E.env_step(
                spec, st, E.bbox_actions(acts, H, W))
            done = term | trunc
            need = trunc & ~term
            fv = torch.zeros_like(v)
            if bool(need.any()):
                with torch.no_grad():
                    fv[need] = policy.value(p, policy.observe(s2)[need], prec)
            out["log_probs"][t], out["values"][t] = lp, v
            out["rewards"][t], out["final_values"][t] = rew, fv
            out["dones"][t], out["terminated"][t] = done, term
            out["need"][t] = need
            if pool is not None:
                fresh = E.fresh_from_pool(pool, counter, spec.max_trial,
                                          s2.reset_on_submit)
                counter = counter + done.long()
            else:
                fresh, bad = next_episode_rows(rec, i, t, s2, spec, bank,
                                               done)
                resets_bad += bad
            st = E.merge_done(done, fresh, s2)
        with torch.no_grad():
            last_v = policy.value(p, policy.observe(st), prec)
        traj = dict(out, obs=obs_buf, actions=acts_all)
        batch = make_batch(traj, last_v, L, size)
        perms = it.get("perms")
        rows = torch.arange(T * B, device=acts_all.device)
        if perms is None and (L["n_epochs"], L["n_minibatches"]) != (1, 1):
            resets_bad += 1           # the learner drew no shuffle
            perms = [rows] * L["n_epochs"]
        elif perms is not None:
            ok = [torch.equal(torch.sort(q)[0], rows) for q in perms]
            resets_bad += ok.count(False)
            perms = [q if good else rows for q, good in zip(perms, ok)]
        n0 = len(learner.losses)
        loss = learner.train(policy, batch, perms, ent_coeff, prec, fault)
        res = {k: out[k] for k in out}
        res["loss"] = loss
        res["update_losses"] = learner.losses[n0:]
        if digest_w is not None:
            res["obs_digest"] = torch.stack([digest(obs_buf[t], digest_w)
                                             for t in range(T)])
        else:
            res["obs"] = obs_buf
        iters_out.append(res)
        if i == 0:
            params_1 = learner.params()
            params_1 = {k: v.clone() for k, v in params_1.items()}
        del batch, traj
    return {"iters": iters_out, "final": st,
            "first_grads": learner.first_grads,
            "params_after": learner.params(), "params_after_1": params_1,
            "resets_bad": resets_bad}


def next_episode_rows(rec, i, t, s2, spec, bank, done):
    """The auto-reset rows of step ``t`` of iteration ``i`` where no pool
    rides the carry: the port draws them from its own generator, so the
    reference takes them from the port's next observation (or its final
    state) and checks that each is a fresh episode of the bank."""
    from .gpt import observe
    iters = rec["iters"]
    T = iters[i]["actions"].shape[0]
    if t + 1 < T:
        nxt = iters[i]["obs"][t + 1]
    elif i + 1 < len(iters):
        nxt = iters[i + 1]["obs"][0]
    else:
        nxt = observe(rec["final"])
    h, w = s2.grid.shape[-2:]
    P = h * w
    B = nxt.shape[0]
    grid = nxt[:, :P].reshape(B, h, w)
    gdim = nxt[:, P:P + 2]
    ans = nxt[:, P + 2:2 * P + 2].reshape(B, h, w)
    adim = nxt[:, 2 * P + 2:2 * P + 4]
    fresh = E.init_state(grid, gdim, ans, adim, max_trial=spec.max_trial,
                         reset_on_submit=s2.reset_on_submit)
    bad = 0
    if bool(done.any()):
        d = done
        bad = int((~torch.as_tensor(bank.members(
            grid[d], gdim[d], ans[d], adim[d]))).sum())
    return fresh, bad

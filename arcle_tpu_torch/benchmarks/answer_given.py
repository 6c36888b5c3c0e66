"""Paper §4.1 benchmark: "Solving ARC with a given answer".

Counterpart of ``arcle_tpu/benchmarks/answer_given.py``.  The reference's
headline published result (§4.1.1) is produced in this setting:

* operations ``Color0..Color{k-1}`` only, selection as a bounding box;
* the state sufficient for decision making is ``(grid, grid_dim, answer,
  answer_dim)``: the answer is *given*;
* dense reward ``r = -(incorrect pixels) / (total pixels)`` in [-1, 0];
* the episode succeeds (terminates) when the grid equals the answer;
* two task distributions: the **random setting** (uniformly random 5x5
  initial grid and goal) and the **ARC setting** (ARC-like tasks whose
  grids are at most 5x5);
* PPO with three auxiliary losses (L_{r_{t-1}}, L_{r_t}, L_{s_{t+1}}) and
  the colour-equivariant policy of §4.1.2.

This module supplies the setting; the policy is
:class:`~arcle_tpu_torch.models.gpt.GPTPolicy` configured at 5x5 with
colour ops only, and the trainer is
:mod:`arcle_tpu_torch.training.train_answer_given`.  On a CUDA bank every
env step launches the step kernel (its 5x5 instantiation, on a table with
no Submit op); on a CPU bank it takes the plain transition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.state import EnvState, I8, I32, F32
from ..envs.core import BatchedEnv, ResetOptions
from ..loaders.loader import ListLoader, Loader, TaskTuple
from ..loaders.synthetic import make_tasks
from ..models import bbox_dist
from ..models.gpt import GPTConfig, GPTPolicy
from ..ops.groups import G
from ..ops.table import OpTable
from ..training.agents import Agent, PolicyGraphs, apply
from ..utils.metrics import TRACE


# ---------------------------------------------------------------------------
# Task distributions
# ---------------------------------------------------------------------------
class RandomPairLoader(Loader):
    """The paper's **random setting**: each task is one (initial grid,
    goal) pair of independent uniformly random ``h x w`` grids over
    ``colors`` colours.  A large ``n_tasks`` stands in for the paper's
    per-episode resampling.  The draws come from
    ``np.random.default_rng(seed)`` in the JAX package's order (grid, then
    goal, task by task), so a seed gives the same bank in both packages."""

    def __init__(self, n_tasks: int = 16384, h: int = 5, w: int = 5,
                 colors: int = 10, seed: int = 0):
        self._n = n_tasks
        self._h, self._w = h, w
        self._colors = colors
        self._seed = seed
        super().__init__()

    def get_path(self, **kw) -> List[str]:
        return ["<random>"] * self._n

    def parse(self, **kw) -> List[TaskTuple]:
        rng = np.random.default_rng(self._seed)
        out = []
        for k in range(self._n):
            g = rng.integers(0, self._colors,
                             (self._h, self._w)).astype(np.int8)
            a = rng.integers(0, self._colors,
                             (self._h, self._w)).astype(np.int8)
            out.append(([g], [a], [g.copy()], [a.copy()],
                        {"id": f"rand{k:06d}"}))
        return out


def small_arc_loader(n_tasks: int = 512, max_size: int = 5,
                     colors: int = 10, seed: int = 0) -> Loader:
    """The paper's **ARC setting**: initial grids and goals at most 5x5.
    ARC-like synthetic tasks stand in for the corpus (a consistent hidden
    rule per task, dims <= ``max_size``).

    Only tasks whose every pair keeps its shape are kept: colour ops
    cannot change the grid's dims, so any other pair is unsolvable here.
    Batches of ``n_tasks`` candidates are drawn, the seed moving on by
    1000003, until ``n_tasks`` are kept."""
    kept: List[TaskTuple] = []
    batch_seed = seed
    while len(kept) < n_tasks:
        for t in make_tasks(n_tasks, seed=batch_seed, min_size=2,
                            max_size=max_size, n_train=2, n_test=1,
                            colors=colors):
            ti, to, ei, eo, _ = t
            if all(i.shape == o.shape for i, o in zip(ti + ei, to + eo)):
                kept.append(t)
                if len(kept) >= n_tasks:
                    break
        batch_seed += 1000003
    return ListLoader(kept)


# ---------------------------------------------------------------------------
# Op table and environment
# ---------------------------------------------------------------------------
def color_table(n_colors: int = 10) -> OpTable:
    """Color0..Color{k-1} only.  No Submit: success is checked against the
    answer after every step (``terminate_on_match``)."""
    return OpTable(
        name=f"AnswerGiven{n_colors}",
        group=tuple([G.COLOR] * n_colors),
        param=tuple(range(n_colors)),
        reset_sel=tuple([False] * n_colors),
        max_trial=-1,
        submit_op=-1,
    )


def answer_given_env(n_tasks: int = 16384, h: int = 5, w: int = 5,
                     colors: int = 10, seed: int = 0,
                     episode_limit: int = 50, setting: str = "random",
                     loader: Optional[Loader] = None,
                     device="cuda") -> BatchedEnv:
    """Batched lockstep env of the §4.1 setting on ``device`` (the card
    unless the caller asks for another).

    ``setting``: "random" (uniform grids) or "arc" (ARC-like tasks of at
    most ``h x w``)."""
    if loader is None:
        if setting == "random":
            loader = RandomPairLoader(n_tasks, h, w, colors, seed)
        elif setting == "arc":
            loader = small_arc_loader(min(n_tasks, 1024), max(h, w), colors,
                                      seed)
        else:
            raise ValueError(setting)
    return BatchedEnv(
        table=color_table(colors), bank=loader.bank(H=h, W=w, device=device),
        max_trial=-1, episode_limit=episode_limit, auto_reset=True,
        pixel_reward=True, terminate_on_match=True,
        opts=ResetOptions.make(adaptation=True, device=device))


# ---------------------------------------------------------------------------
# Observation + agent
# ---------------------------------------------------------------------------
def answer_obs(state: EnvState) -> torch.Tensor:
    """Flat int8 ``[B, h*w + 2 + h*w + 2]`` observation: the paper's
    sufficient state (grid, grid_dim, answer, answer_dim), grid cells first
    (the aux L_{s_{t+1}} target slice is ``[0, h*w)``).

    The JAX package stores this observation as float32; here it is int8,
    the dtype of the state's fields and of ``Trajectory.obs``: cells are
    colours 0..9 and dims are at most 30, so the cast loses nothing."""
    B = state.grid.shape[0]
    return torch.cat([
        state.grid.reshape(B, -1).to(I8), state.grid_dim.to(I8),
        state.answer.reshape(B, -1).to(I8), state.answer_dim.to(I8),
    ], dim=-1)


def shaping_potential(obs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """phi(s) = -(wrong cells inside ``answer_dim``) / (answer area), read
    off the flat answer-given observation (any leading batch dims, any
    numeric dtype); float32.  It equals :func:`arcle_tpu_torch.ops.table
    .pixel_reward` of the same state, so the trainer's potential-based
    shaping (phi(s_{t+1}) == r_t) is policy-invariant in the ARC setting
    too, where dims can be smaller than ``h x w``."""
    P = h * w
    g = obs[..., :P]
    a = obs[..., P + 2:2 * P + 2]
    ad = obs[..., 2 * P + 2:2 * P + 4].to(I32)
    idx = torch.arange(P, dtype=I32, device=obs.device)
    r_idx = idx // w
    c_idx = idx - r_idx * w
    inside = (r_idx < ad[..., :1]) & (c_idx < ad[..., 1:2])
    wrong = (inside & (g != a)).sum(-1).to(F32)
    area = torch.clamp(ad[..., 0] * ad[..., 1], min=1).to(F32)
    return -wrong / area


def _unpack(obs: torch.Tensor, h: int, w: int):
    """The observation's four fields as int8: grid and answer ``[..., h,
    w]``, their dims ``[..., 2]``."""
    p = h * w
    lead = obs.shape[:-1]
    grid = obs[..., :p].to(I8).reshape(*lead, h, w)
    grid_dim = obs[..., p:p + 2].to(I8)
    ans = obs[..., p + 2:2 * p + 2].to(I8).reshape(*lead, h, w)
    ans_dim = obs[..., 2 * p + 2:2 * p + 4].to(I8)
    return grid, grid_dim, ans, ans_dim


def make_policy(h: int = 5, w: int = 5, colors: int = 10,
                n_layer: int = 4, n_head: int = 4, n_embd: int = 128,
                factorized: bool = False, color_equivariant: bool = True,
                bbox_dist_kind: str = "categorical",
                generator: Optional[torch.Generator] = None) -> GPTPolicy:
    """The §4.1.2 policy family at benchmark scale (bf16, ``GPTConfig``'s
    default dtype; no dropout, no recomputation).

    ``color_equivariant=True`` (default) is the paper's colour-equivariant
    architecture: colour-op tokens are pure functions of the colour
    embedding.  ``factorized=True`` is the paper's *non-sequential*
    control: operation and selection from two independent special tokens.
    ``bbox_dist_kind``: "categorical" (default: a discrete per-coordinate
    selection head of ``max(h, w)`` bins, exact log-probs on the small
    grid) or "truncnorm" (the reference's AROPandBBox parameterisation)."""
    cfg = GPTConfig(grid_x=h, grid_y=w, num_colors=colors,
                    num_actions=colors, n_layer=n_layer, n_head=n_head,
                    n_embd=n_embd, embd_pdrop=0.0, resid_pdrop=0.0,
                    attn_pdrop=0.0, remat=False, factorized=factorized,
                    color_equivariant=color_equivariant,
                    bbox_bins=(max(h, w)
                               if bbox_dist_kind == "categorical" else 0))
    return GPTPolicy(cfg, generator)


def answer_given_agent(model: GPTPolicy, min_log_std: float = -2.3,
                       sequential: bool = False) -> Agent:
    """Agent over the (grid, answer) observation; the answer rides in the
    policy's second grid slot (the reference GPT feeds ``input`` there).

    Two benchmark-local deviations from the reference's distribution: a
    floor on the bbox std (``min_log_std`` = -2.3, std 0.1 on the [0, 1]
    support; the reference allows exp(-20)) and quantised sampled
    log-probs (PPO ratios start at exactly 1).

    ``sequential`` is §4.1.2's architecture (2): the selection
    distribution comes from a second forward with the sampled operation's
    token appended, so ``sample_fn`` and ``evaluate_fn`` run two forwards.
    ``u`` of ``sample_fn`` is ``(u_op, u_bbox)``, the uniforms of the two
    draws (see :mod:`models.bbox_dist`)."""
    c = model.cfg
    h, w = c.grid_x, c.grid_y
    grid_size = max(h, w)
    categorical = c.bbox_bins > 0
    graphs = PolicyGraphs()

    def forward(params, obs, **kw):
        grid, grid_dim, ans, ans_dim = _unpack(obs, h, w)
        z = torch.zeros((grid.shape[0],), dtype=I8, device=obs.device)
        return apply(model, params, grid, grid_dim, ans, ans_dim, z, z, **kw)

    def sel_source(params, obs, op, out1):
        """Where the selection distribution reads from: the unconditioned
        pass (architectures (1) and (3)), or a second forward conditioned
        on ``op`` alone (the appended bbox token carries a constant 0)."""
        if not sequential:
            return out1
        return forward(params, obs, operation=op.to(I32),
                       bbox=torch.zeros(op.shape + (4,), dtype=F32,
                                        device=obs.device))

    def sample_core(params, obs, u_op, u_bb, deterministic):
        out = forward(params, obs)
        logits = out["op_logits"]
        if deterministic:
            op = torch.argmax(logits, dim=-1)
        else:
            op = bbox_dist._categorical(logits, None, u_op)
        lp_op = bbox_dist.op_log_softmax_at(logits, op)
        src = sel_source(params, obs, op, out)
        if categorical:
            bl = bbox_dist._select_op_logits(src["bbox_logits_all"], op)
            if deterministic:
                coords = torch.argmax(bl, dim=-1)
            else:
                coords = bbox_dist._categorical(bl, None, u_bb)
            lp_bb = bbox_dist._log_softmax_at(bl, coords).sum(-1)
            bbox = coords.to(I32)
        else:
            dist = bbox_dist.make_dist(src["bbox_mean_all"],
                                       src["bbox_std_all"], op, min_log_std)
            x = dist.mean() if deterministic else dist.sample(u=u_bb)
            x = torch.clamp(x, 0.0, 1.0)
            bbox = torch.clamp(torch.floor(x * grid_size), 0,
                               grid_size - 1).to(I32)
            lp_bb = dist.log_prob(bbox.to(F32) / grid_size).sum(-1)
        acts = torch.cat([bbox, op[..., None].to(I32)], dim=-1)
        return acts, lp_op + lp_bb, out["value"]

    def evaluate_core(params, obs, actions):
        out = forward(params, obs)
        op = actions[..., 4]
        src = sel_source(params, obs, op, out)
        if categorical:
            lp = bbox_dist.log_prob_categorical(
                out["op_logits"], src["bbox_logits_all"], op,
                actions[..., :4])
            ent = bbox_dist.entropy_categorical(
                out["op_logits"], src["bbox_logits_all"], op)
        else:
            lp = bbox_dist.log_prob(
                out["op_logits"], src["bbox_mean_all"], src["bbox_std_all"],
                op, actions[..., :4], grid_size, min_log_std=min_log_std)
            ent = bbox_dist.entropy(
                out["op_logits"], src["bbox_mean_all"], src["bbox_std_all"],
                op, min_log_std=min_log_std)
        return lp, out["value"], ent

    sample, evaluate = graphs.wrap(sample_core), graphs.wrap(evaluate_core)

    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        with TRACE.span("policy"):
            u_op = u_bb = None
            if not deterministic:
                u_op, u_bb = bbox_dist.draw_uniforms(
                    obs.shape[:-1], c.num_actions, generator, obs.device,
                    c.bbox_bins, u)
            return sample(params, obs, u_op, u_bb,
                          deterministic=deterministic)

    def evaluate_fn(params, obs, actions):
        with TRACE.span("policy"):
            return evaluate(params, obs, actions)

    def aux_fn(params, obs, actions):
        """The action-conditioned forward for L_{r_t} / L_{s_{t+1}}
        (§4.1.1); r_{t-1} is read from the same pass (see
        training/agents.py)."""
        out = forward(params, obs, operation=actions[..., 4].to(I32),
                      bbox=actions[..., :4].to(F32) / grid_size)
        return {"rtm1": out["aux_rtm1"], "r": out["aux_reward"],
                "g_logits": out["aux_transition"]}

    def init_fn(generator: Optional[torch.Generator] = None) -> GPTPolicy:
        return GPTPolicy(c, generator)

    return Agent(obs_fn=answer_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=2 * h * w + 4, aux_fn=aux_fn, graphs=graphs)


@dataclasses.dataclass(frozen=True)
class AnswerGivenConfig:
    """One §4.1 experiment cell."""

    setting: str = "random"        # "random" | "arc"
    h: int = 5
    w: int = 5
    colors: int = 10
    n_tasks: int = 16384
    episode_limit: int = 50
    # policy (§4.1.2): color_eq | nonseq (factorized control) |
    # sequential (two-pass selection conditioned on the sampled op)
    arch: str = "color_eq"
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 128
    # aux losses (§4.1.1); subsets for the Figure-5 ablation
    aux: str = "all"               # "none" | "rtm1" | "rtm1+rt" | "all"

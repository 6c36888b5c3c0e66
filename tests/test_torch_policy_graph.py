"""The policy's calls replayed as CUDA graphs (``training/agents.py::
PolicyGraphs``) for the three agents: the MLP, the GPT with the
truncated-normal bbox head and the answer-given policy with the
categorical one.

On the CPU: ``sample_fn``, which now draws its uniforms first and hands
them to a forward that draws nothing, gives the actions, log-probs and
values of the sampler that drew inside the forward, bit for bit, and
leaves the generator where it did; and no graph is captured on the CPU,
under grad or with a name -> tensor mapping.  On the card (marked ``gpu``,
skipped without one: ``python -m pytest tests/test_torch_policy_graph.py
-m gpu``): a replay equals the eager call bit for bit, across Adam steps,
its outputs belong to the caller, and a moved parameter or a new batch
size captures anew.  This file imports no JAX.
"""

import pytest
import torch

from arcle_tpu_torch.benchmarks.answer_given import (
    _unpack, answer_given_agent, make_policy)
from arcle_tpu_torch.models import bbox_dist
from arcle_tpu_torch.models.gpt import GPTConfig, GPTPolicy
from arcle_tpu_torch.models.mlp import (
    FCPolicy, multi_categorical_log_prob, multi_categorical_sample,
    stack_padded_logits)
from arcle_tpu_torch.training.agents import gpt_agent, mlp_agent
from arcle_tpu_torch.utils.metrics import TRACE
from arcle_tpu_torch.wrappers import FULL_OBS_DIM, unflatten_full

KINDS = ("mlp", "gpt", "answer_given")
MODES = [pytest.param(False, id="sampled"),
         pytest.param(True, id="deterministic")]


def build(kind, device="cpu", full=False):
    """An agent, its policy (weights drawn from a seed) and a function
    ``obs(B, generator)`` of valid observations on ``device``.  ``full``:
    the cells' widths (on the card)."""
    g = torch.Generator().manual_seed(11)
    if kind == "mlp":
        model = FCPolicy(n_ops=35, generator=g) if full else \
            FCPolicy(hidden=(32, 16), n_ops=5, H=4, W=4, generator=g)
        agent, lo, hi, D = mlp_agent(model), 0, 10, model.obs_dim
    elif kind == "gpt":
        cfg = GPTConfig(n_layer=2, n_head=4, n_embd=64) if full else \
            GPTConfig(n_layer=1, n_head=2, n_embd=16, dtype=torch.float32)
        model = GPTPolicy(cfg, g)
        agent, lo, hi, D = gpt_agent(model), 0, 10, FULL_OBS_DIM
    else:
        model = make_policy(generator=g) if full else \
            make_policy(n_layer=1, n_head=2, n_embd=16, generator=g)
        agent, lo, hi, D = answer_given_agent(model), 1, 5, 54
    model = model.to(device)

    def obs(B, gen):
        return torch.randint(lo, hi, (B, D), generator=gen,
                             dtype=torch.int8).to(device)

    return agent, model, obs


def eager_sample(kind, model, obs, generator, deterministic):
    """The samplers as they drew before the split: the forward, then each
    draw from ``generator`` inside the distribution's code."""
    if kind == "mlp":
        logits, value = model(obs)
        if deterministic:
            acts = torch.argmax(stack_padded_logits(logits), -1).to(
                torch.int32)
            return acts, multi_categorical_log_prob(logits, acts), value
        acts, lp = multi_categorical_sample(logits, generator)
        return acts, lp, value
    if kind == "gpt":
        f = unflatten_full(obs)
        out = model(f["grid"], f["grid_dim"], f["input"], f["input_dim"],
                    f["trials_remain"], f["active"])
        s = bbox_dist.sample(out["op_logits"], out["bbox_mean_all"],
                             out["bbox_std_all"], 30, deterministic,
                             generator=generator)
        acts = torch.cat([s.bbox, s.operation[..., None]], -1)
        return acts, s.log_prob, out["value"]
    z = torch.zeros(obs.shape[0], dtype=torch.int8)
    out = model(*_unpack(obs, 5, 5), z, z)
    s = bbox_dist.sample_categorical(out["op_logits"], out["bbox_logits_all"],
                                     deterministic, generator=generator)
    acts = torch.cat([s.bbox, s.operation[..., None]], -1)
    return acts, s.log_prob, out["value"]


@pytest.mark.parametrize("deterministic", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_drawing_first_gives_the_eager_samplers_draws(kind, deterministic):
    agent, model, make_obs = build(kind)
    obs = make_obs(6, torch.Generator().manual_seed(3))
    g_new, g_old = (torch.Generator().manual_seed(21) for _ in range(2))
    with torch.no_grad():
        for _ in range(2):     # the second draw starts where the first ended
            new = agent.sample_fn(model, obs, g_new, deterministic)
            old = eager_sample(kind, model, obs, g_old, deterministic)
            for a, b, what in zip(new, old, ("actions", "log_prob", "value")):
                assert a.dtype == b.dtype and torch.equal(a, b), what
            assert torch.equal(g_new.get_state(), g_old.get_state())
    assert not deterministic or torch.equal(
        g_new.get_state(), torch.Generator().manual_seed(21).get_state())


def _calls(agent, params, obs, generator, n):
    return [(agent.sample_fn(params, obs, generator),
             agent.evaluate_fn(params, obs,
                               agent.sample_fn(params, obs, generator)[0]))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["no grad", "grad", "mapping"])
@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("kind", KINDS)
def test_graphs_stay_off_where_a_call_is_not_safe(kind, device, case):
    """No graph on the CPU, under grad or with a parameter mapping (on
    the card a module called without grad is the only case that graphs,
    and is left to the card tests below)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if device == "cuda" and case == "no grad":
        pytest.skip("graphed on the card: see the replay tests")
    agent, model, make_obs = build(kind, device)
    obs = make_obs(4, torch.Generator().manual_seed(3))
    params = dict(model.named_parameters()) if case == "mapping" else model
    TRACE.start()
    try:
        with torch.set_grad_enabled(case == "grad"):
            out = _calls(agent, params, obs,
                         torch.Generator(device).manual_seed(1), 3)
    finally:
        TRACE.stop()
    assert agent.graphs.captures == agent.graphs.replays == 0
    names = [s[0] for s in TRACE.spans]
    assert "policy" in names and "policy_graph" not in names
    assert all(torch.isfinite(v).all() for s, e in out for v in (*s[1:], *e))


# ---- on the card -------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _adam_step(agent, model, opt, obs, acts):
    """One Adam step on a loss of the learner's kind, which writes the
    parameters in place."""
    with torch.enable_grad():
        lp, value, ent = agent.evaluate_fn(model, obs, acts)
        loss = -(lp.float().mean() + ent.float().mean()) + \
            value.float().pow(2).mean()
        opt.zero_grad()
        loss.backward()
    opt.step()


@pytest.mark.gpu
@pytest.mark.parametrize("deterministic", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_a_replay_equals_the_eager_call(cuda_device, kind, deterministic):
    """20 sampling and 20 evaluating calls at the cells' widths, an Adam
    step between calls: the graphs' outputs equal the eager calls' (the
    same agent given a parameter mapping) bit for bit, the generators move
    alike, an output is not changed by the next call, and every call after
    each key's first is a replay."""
    agent, model, make_obs = build(kind, cuda_device, full=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    B, n = 64, 20
    g_graph, g_eager = (torch.Generator(cuda_device).manual_seed(5)
                        for _ in range(2))
    obs_gen = torch.Generator().manual_seed(6)
    before = None
    for i in range(n):
        obs = make_obs(B, obs_gen)
        mapping = dict(model.named_parameters())
        with torch.no_grad():
            out = agent.sample_fn(model, obs, g_graph, deterministic)
            ref = agent.sample_fn(mapping, obs, g_eager, deterministic)
            ev = agent.evaluate_fn(model, obs, out[0])
            ev_ref = agent.evaluate_fn(mapping, obs, ref[0])
        for a, b, what in zip((*out, *ev), (*ref, *ev_ref),
                              ("actions", "log_prob", "value", "eval "
                               "log_prob", "eval value", "entropy")):
            assert torch.equal(a, b), (i, what, (a.float() - b.float())
                                       .abs().max().item())
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        if before is not None:
            for a, b in zip(before[0], before[1]):
                assert torch.equal(a, b), i
        before = (out, tuple(t.clone() for t in out))
        _adam_step(agent, model, opt, obs, out[0])
    torch.cuda.synchronize()
    assert agent.graphs.captures == 2
    assert agent.graphs.replays == 2 * n - 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_a_moved_parameter_or_a_new_batch_captures_anew(cuda_device, kind):
    agent, model, make_obs = build(kind, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    obs_gen = torch.Generator().manual_seed(3)

    def check(B):
        obs = make_obs(B, obs_gen)
        mapping = dict(model.named_parameters())
        with torch.no_grad():
            state = gen.get_state()
            out = agent.sample_fn(model, obs, gen)
            gen.set_state(state)
            ref = agent.sample_fn(mapping, obs, gen)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)

    for _ in range(3):
        check(8)
    assert (agent.graphs.captures, agent.graphs.replays) == (1, 2)
    p = next(model.parameters())
    p.data = p.data + 0.5                 # rebound: the old graph is stale
    for _ in range(3):
        check(8)
    assert (agent.graphs.captures, agent.graphs.replays) == (2, 4)
    for _ in range(3):
        check(16)
    assert (agent.graphs.captures, agent.graphs.replays) == (3, 6)
    model.to(cuda_device)                 # already there: nothing moves
    check(16)
    assert (agent.graphs.captures, agent.graphs.replays) == (3, 7)

"""The port's span recorder (``utils/metrics.py::TRACE``) on the CPU: off it
records nothing; on, one PPO iteration leaves the tree of its layers;
spans land on the ``torch.profiler`` trace's clock; the collector's passes
are spans of their own."""

from __future__ import annotations

import gc
import time
from collections import Counter

import pytest
import torch

from arcle_tpu_torch.training.ppo import PPOConfig
from arcle_tpu_torch.training.rollout import rollout
from arcle_tpu_torch.training.train import ppo_iteration, setup_ppo
from arcle_tpu_torch.utils import EnvConfig, RunConfig
from arcle_tpu_torch.utils.metrics import TRACE

T = 4


@pytest.fixture
def recorder():
    TRACE.stop()
    yield TRACE
    TRACE.stop()


@pytest.fixture(scope="module")
def run():
    cfg = RunConfig(seed=0, algo="ppo", device="cpu",
                    env=EnvConfig(n_envs=4, episode_limit=3,
                                  n_synthetic_tasks=4, reset_pool=2),
                    ppo=PPOConfig(n_epochs=1, n_minibatches=2),
                    mlp_hidden=(16,))
    r = setup_ppo(cfg)
    r.n_steps = T
    return r


def _children(spans):
    """Each span's children's names in order, the collector's left out."""
    kids = {i: [] for i in range(len(spans))}
    for i, (name, _, _, parent) in enumerate(spans):
        if name != "gc" and parent >= 0:
            kids[parent].append(i)
    return kids


def test_off_it_records_nothing(recorder, run):
    recorder.start()
    recorder.stop()
    rollout(run.env, run.bs, run.params, run.generator, T, run.agent)
    assert recorder.spans == []
    assert recorder.span("policy") is recorder.span("env.step")


def test_one_ppo_iteration_leaves_the_tree_of_its_layers(recorder, run):
    recorder.start()
    ppo_iteration(run)
    recorder.stop()
    spans = recorder.spans
    kids = _children(spans)
    names = lambda idx: [spans[i][0] for i in idx]
    roots = [i for i, s in enumerate(spans) if s[3] < 0 and s[0] != "gc"]
    assert names(roots) == ["iteration"]
    it = roots[0]
    assert names(kids[it]) == ["rollout", "learner_batch", "update"]
    ro, _, up = kids[it]
    # per step: the sampling forward, the step, the bootstrap forward; then
    # the last value
    assert names(kids[ro]) == (["reset_pool"]
                               + ["policy", "env.step", "policy"] * T
                               + ["policy"])
    steps = [i for i in kids[ro] if spans[i][0] == "env.step"]
    for i in steps:
        assert names(kids[i]) == ["step_kernel", "auto_reset"]
    assert names(kids[up]) == ["minibatch"] * 2
    for i in kids[up]:
        assert names(kids[i]) == ["policy"]
    counts = Counter(s[0] for s in spans if s[0] != "gc")
    assert counts == {"iteration": 1, "rollout": 1, "reset_pool": 1,
                      "env.step": T, "step_kernel": T, "auto_reset": T,
                      "policy": 2 * T + 1 + 2, "learner_batch": 1,
                      "update": 1, "minibatch": 2}
    for name, a, b, parent in spans:
        assert 0 < a <= b
        if parent >= 0:
            pa, pb = spans[parent][1:3]
            assert pa <= a and b <= pb, name


def test_spans_lie_on_the_profilers_clock(recorder):
    """Under ``torch.profiler`` the recorder records by itself; each
    operator run inside a span lies inside it once mapped by the clock
    pair."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("a"):
            x.add(1)
        time.sleep(0.002)
        with recorder.span("b"):
            x.mul(2)
            time.sleep(0.002)
            with recorder.span("c"):
                x.sub(1)
    assert recorder.on
    recorder.span("after")              # the trace has stopped: so does it
    assert not recorder.on
    by_name = {s[0]: s for s in recorder.spans}
    assert set(by_name) >= {"a", "b", "c"}
    assert by_name["c"][3] == recorder.spans.index(by_name["b"])
    slack = 20_000
    want = {"aten::add": "a", "aten::mul": "b", "aten::sub": "c"}
    seen = Counter()
    for e in prof.profiler.kineto_results.events():
        span = want.get(e.name())
        if span is None:
            continue
        a, b = (recorder.to_unix_ns(t) for t in by_name[span][1:3])
        s = int(e.start_ns())
        assert a - slack <= s and s + int(e.duration_ns()) <= b + slack, \
            (e.name(), s - a, b - s)
        seen[span] += 1
    assert seen == {"a": 1, "b": 1, "c": 1}


def test_a_collector_pass_is_a_child_span(recorder):
    recorder.start()
    with recorder.span("outer"):
        gc.collect()
    recorder.stop()
    outer = [i for i, s in enumerate(recorder.spans) if s[0] == "outer"]
    passes = [s for s in recorder.spans if s[0] == "gc"]
    assert passes and all(s[3] == outer[0] and s[2] >= s[1]
                          for s in passes)


def test_stop_removes_the_collector_hook(recorder):
    recorder.start()
    assert recorder._gc_hook in gc.callbacks
    recorder.stop()
    assert recorder._gc_hook not in gc.callbacks
    n = len(recorder.spans)
    gc.collect()
    assert len(recorder.spans) == n

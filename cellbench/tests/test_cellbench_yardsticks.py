"""The frozen yardsticks against the port's own arithmetic, on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from cellbench import harness as H
from cellbench.cost import flops
from cellbench.cost.step_kernel_bytes import HBM_BYTES_PER_S
from cellbench.cost.step_kernel_bytes import step_kernel_bytes as frozen
from cellbench.reference import engine as E
from cellbench.tests.tiny import BENCH


def _tables(name):
    from arcle_tpu_torch.ops import arc_table, o2arc_table, raw_table
    from cellbench.reference.engine import table as T
    return {"o2arc_crop33": (o2arc_table(127, crop_at_33=True),
                             T.o2arc_table(127, crop_at_33=True)),
            "arc": (arc_table(3), T.arc_table(3)),
            "raw": (raw_table(-1), T.raw_table(-1))}[name]


@pytest.mark.parametrize("name,point", [("o2arc_crop33", False),
                                        ("arc", True), ("raw", False)])
def test_step_kernel_bytes_copy_equals_the_port(name, point):
    from arcle_tpu_torch.benchmarks import roofline
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.envs.rollout import (random_bbox_actions,
                                              random_point_actions)
    from arcle_tpu_torch.loaders import SyntheticLoader
    port_table, ref_table = _tables(name)
    env = BatchedEnv(table=port_table,
                     bank=SyntheticLoader(8, seed=3).bank(device="cpu"),
                     max_trial=port_table.max_trial, episode_limit=5,
                     auto_reset=True, augment=True, reset_pool=2)
    gen = torch.Generator().manual_seed(17)
    bs = env.reset(gen, 24)
    draw = random_point_actions if point else random_bbox_actions
    limit = roofline.step_kernel_bytes_max(port_table, 30, 30)
    for _ in range(8):
        act = draw(gen, 24, port_table.n_ops, 30, 30, "cpu")
        got = frozen(bs.env, act, ref_table)
        assert got == roofline.step_kernel_bytes(bs.env, act, port_table)
        assert 0 < got <= 24 * limit
        bs = env.step(bs, act)[0]


def _mlp_config(hidden):
    cfg = json.loads((BENCH / "configs/o2arc_mlp.json").read_text())
    cfg["policy"]["hidden"] = list(hidden)
    return cfg


@pytest.mark.parametrize("hidden", [(64, 32), (48,), (32, 32, 16)])
def test_mlp_flops_match_the_flop_counter(hidden):
    """The analytic count of a forward, and of a forward and backward
    with no gradient for the observation, equals PyTorch's count."""
    from torch.utils.flop_counter import FlopCounterMode
    from arcle_tpu_torch.models.mlp import FCPolicy
    f = flops.of(_mlp_config(hidden))
    pol = FCPolicy(hidden=hidden, n_ops=35)
    obs = torch.randint(0, 10, (8, 2710), dtype=torch.int8)
    with FlopCounterMode(display=False) as c:
        with torch.no_grad():
            pol(obs)
    assert c.get_total_flops() == 8 * f["act"]
    with FlopCounterMode(display=False) as c:
        logits, v = pol(obs)
        (sum(l.sum() for l in logits) + v.sum()).backward()
    assert c.get_total_flops() == 8 * f["update_row"]


def _trace(kernels):
    tr = H.Trace.__new__(H.Trace)
    tr.kernels = [("marker", 0, 1000)] + kernels
    tr.start_event = None
    return tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shares_stay_within_0_and_100_on_synthetic_traces(seed):
    g = torch.Generator().manual_seed(seed)
    window_s = 0.01
    n = 400
    starts = torch.randint(1000, 1000 + int(window_s * 1e9), (n,),
                           generator=g)
    durs = torch.randint(1, 200_000, (n,), generator=g)
    names = ["void step_kernel<30, 30>(Params)", "gemm", "elementwise"]
    kernels = sorted((names[i % 3], int(s), int(d))
                     for i, (s, d) in enumerate(zip(starts, durs)))
    kernels = [(k[0], k[1], k[2]) for k in sorted(kernels,
                                                  key=lambda k: k[1])]
    tr = _trace(kernels)
    busy, gaps = tr.busy_idle(window_s)
    assert 0 < busy <= window_s
    assert abs(busy + sum(b - a for a, b in gaps) / 1e9 - window_s) < 1e-9
    idle = H.metric_reader("device_idle_pct.train")(
        {"busy_s": busy, "window_s": window_s})
    assert 0 <= idle <= 100
    k_s = tr.kernel_seconds("step_kernel")
    assert 0 < k_s < sum(d for _, _, d in kernels) / 1e9
    # bytes that a kernel at the bandwidth would move in that time
    env_steps = 1000
    per = HBM_BYTES_PER_S * k_s / env_steps * float(
        torch.rand((), generator=g))
    roof = H.metric_reader("step_kernel_roofline_pct.engine")(
        {"trace": tr, "bytes_per_env_step": per, "env_steps": env_steps})
    assert 0 <= roof <= 100
    peak = 989e12
    mfu = H.metric_reader("mfu_pct.eval")(
        {"model_flops": peak * window_s * float(torch.rand((), generator=g)),
         "window_s": window_s, "peak": "bf16",
         "card": "NVIDIA H100 80GB HBM3"})
    assert 0 <= mfu <= 100


def test_a_card_without_listed_peaks_gets_no_share():
    assert H.metric_reader("mfu_pct.train")(
        {"model_flops": 1e12, "window_s": 1.0, "peak": "fp32",
         "card": "cpu"}) is None
    assert H.metric_reader("step_kernel_roofline_pct.engine")(
        {"trace": _trace([]), "bytes_per_env_step": 10.0,
         "env_steps": 5}) is None


def test_the_reference_step_is_the_ports_plain_step():
    """The frozen transition and the reward modes give the port's plain
    step, bit for bit, on random actions."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.envs.rollout import random_bbox_actions
    from arcle_tpu_torch.loaders import SyntheticLoader
    port_table, ref_table = _tables("o2arc_crop33")
    env = BatchedEnv(table=port_table,
                     bank=SyntheticLoader(8, seed=3).bank(device="cpu"),
                     max_trial=127, episode_limit=4, auto_reset=False,
                     dense_reward=True, augment=True)
    spec = E.EnvSpec(table=ref_table, episode_limit=4, dense_reward=True,
                     max_trial=127)
    gen = torch.Generator().manual_seed(5)
    bs = env.reset(gen, 32)
    for _ in range(6):
        act = random_bbox_actions(gen, 32, port_table.n_ops, 30, 30, "cpu")
        st = bs.env
        bs, obs, rew, term, trunc = env.step(bs, act)
        s2, r2, t2, tr2 = E.env_step(spec, st, E.Action(
            selection=act.selection, operation=act.operation))
        assert torch.equal(rew, r2) and torch.equal(term, t2) \
            and torch.equal(trunc, tr2)
        for f in E.FIELDS:
            assert torch.equal(getattr(obs, f), getattr(s2, f)), f

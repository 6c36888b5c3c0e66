"""``bench_cuda.py`` and ``arcle_tpu_torch.benchmarks.bench`` on the CPU:
the CLI's JSON line against ``bench.py``'s schema (``BENCH_r05.json``) at
a tiny size, its refusal to run without CUDA unless asked for the CPU,
that neither imports JAX or ``arcle_tpu``, and the scaling sweep on two
Gloo ranks."""

import json
import math
import os
import subprocess
import sys

import pytest

import bench_cuda
from arcle_tpu_torch.benchmarks import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _schema() -> dict:
    with open(os.path.join(REPO, "BENCH_r05.json")) as fp:
        return json.load(fp)["parsed"]


def test_cli_on_cpu_prints_bench_py_keys(monkeypatch, capsys):
    for name, value in (("ADAPTER_STEPS", 20), ("CORPUS", (4, 6, 2)),
                        ("CONFIG_ENVS", (8, 8)), ("RESET_ENVS", 64),
                        ("TRAIN_HIDDEN", (32, 16))):
        monkeypatch.setattr(bench, name, value)
    assert bench_cuda.main(["--device", "cpu", "--batch", "8", "--steps",
                            "3", "--iters", "1", "--ref-steps", "20"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out, want = json.loads(lines[0]), _schema()
    # bench.py's keys, plus the card, which baseline ran and the train
    # loop's split
    assert set(out) == set(want) | {"device", "baseline", "ppo_train_loop"}
    assert out["device"] == {"name": "cpu", "power_limit_w": None}
    assert out["baseline"] == "oracle" and out["vs_baseline"] > 0
    assert set(out["configs"]) == set(want["configs"]) | {
        "raw_miniarc_1env_native", "roofline"}
    assert out["configs"]["corpus_pairs"] == 4 * 8
    rates = [out["value"], out["ppo_train_loop_steps_per_s"]] + [
        v for k, v in out["configs"].items() if k != "roofline"]
    assert all(math.isfinite(r) and r > 0 for r in rates)
    for util in [out["roofline"], *out["configs"]["roofline"].values()]:
        assert util["engine"] == "plain" and util["launches"] == 0
        assert util["bind"] == ("host" if util["device_busy_pct"] <
                                bench.BUSY_DEVICE_PCT else "device")
        assert 0 < util["device_busy_pct"] <= 100
        assert util["analytic_bytes_per_env_step"] >= 6 * 900
    loop = out["ppo_train_loop"]
    assert loop["dtype"] == "float32" and loop["flops_per_env_step"] > 0
    assert 0 < loop["rollout_ms"] + loop["update_ms"] <= loop["ms_per_iter"]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_cli_without_cuda_exits_nonzero():
    proc = _run("import sys, bench_cuda; sys.exit(bench_cuda.main([]))")
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == "" and "CUDA is not available" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.bench_engine(8, 1, 1, device="cuda")


def test_bench_imports_neither_jax_nor_arcle_tpu():
    proc = _run("import sys, bench_cuda, arcle_tpu_torch.benchmarks.bench\n"
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'arcle_tpu')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_scaling_on_two_gloo_ranks():
    out = bench.bench_scaling(8, 3, (1, 2), "cpu")
    assert set(out) == {1, 2}
    assert out[1][1] == 100.0
    assert all(rate > 0 and eff > 0 for rate, eff in out.values())

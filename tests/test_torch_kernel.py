"""The step kernel's wrapper, and the kernel itself where a card exists.

Here on the CPU: the port imports no JAX, the wrapper takes the plain
version for CPU tensors (and only for them), and a missing CUDA toolkit
raises instead of falling back.  The ``gpu`` tests hold the CUDA kernel to
its plain version bit for bit; they skip without a card and run on one with
``python -m pytest tests/test_torch_kernel.py -m gpu``.  This file imports
no JAX, so it also runs where JAX is not installed.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arcle_tpu_torch.core import Action, FIELDS, state_from_numpy, \
    state_to_numpy
from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.ops import (
    o2arc_table, arc_table, raw_table, finish_flood, step_kernel,
)
from arcle_tpu_torch.testing import step_cases
from arcle_tpu_torch.ops.step_kernel import (
    cuda_step_deferred, plain_step_deferred,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import arcle_tpu_torch\n"
        "import arcle_tpu_torch.envs.rollout, arcle_tpu_torch.ops.step_kernel\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'arcle_tpu' or "
        "m.startswith('arcle_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def small_state(table, batch=16, seed=0):
    env = BatchedEnv(table=table, bank=SyntheticLoader(8, seed=0).bank(device="cpu"),
                     max_trial=3)
    return env.reset(torch.Generator().manual_seed(seed), batch).env


def fuzz_action(rng, batch, n_ops, side=30):
    sels = (rng.random((batch, side, side)) < 0.2).astype(np.int8)
    sels[::3] = 0
    ops = rng.integers(0, n_ops, batch).astype(np.int32)
    return Action(selection=torch.from_numpy(sels),
                  operation=torch.from_numpy(ops))


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """CPU tensors run the plain step: no build, no load, no launch."""
    def no_load():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(step_kernel, "load", no_load)
    before = step_kernel.LAUNCHES
    table = o2arc_table(max_trial=3)
    st = small_state(table)
    rng = np.random.default_rng(0)
    for _ in range(3):
        act = fuzz_action(rng, 16, table.n_ops)
        a = cuda_step_deferred(st, act, table)
        b = plain_step_deferred(st, act, table)
        for name in FIELDS:
            assert torch.equal(getattr(a[0], name), getattr(b[0], name))
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)
        st = a[0]
    assert step_kernel.LAUNCHES == before


def test_wrapper_raises_off_cpu_without_cuda():
    """A tensor on neither the CPU nor CUDA is refused, not stepped."""
    table = raw_table()
    st = small_state(table, batch=2)
    meta = type(st)(**{f.name: getattr(st, f.name).to("meta")
                       for f in dataclasses.fields(st)})
    act = Action(selection=torch.zeros((2, 30, 30), dtype=torch.int8,
                                       device="meta"),
                 operation=torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        cuda_step_deferred(meta, act, table)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: the build fails loudly; nothing falls back."""
    monkeypatch.setattr(step_kernel.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(step_kernel, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        step_kernel.build()


class _RecordingLib:
    """Stands in for the kernel library: records the launch's arguments."""

    def __init__(self):
        self.args = None

    def arcle_step_launch(self, *args):
        self.args = args
        return 0


def test_outputs_are_aligned_views_of_one_arena():
    """The wrapper's 20 outputs: one arena, each view contiguous with the
    plain version's dtype and shape, on a 256-byte boundary, disjoint, at
    the byte offsets the kernel is given."""
    table = o2arc_table(max_trial=3)
    for batch in (16, 13):                  # 13: a ragged last block
        st = small_state(table, batch=batch)
        act = fuzz_action(np.random.default_rng(0), batch, table.n_ops)
        lib = _RecordingLib()
        ks, kr, kt, kp = step_kernel._launch(lib, st, act, table,
                                             table.rows("cpu"), None)
        ps, pr, pt, pp = plain_step_deferred(st, act, table)
        base, offsets = lib.args[1], list(lib.args[2])
        outs = [getattr(ks, n) for n in step_kernel._GRID_OUT +
                step_kernel._DIM_OUT + step_kernel._FLAG_OUT] + \
            [ks.steps, ks.submit_count, ks.last_action_op, kr, kt, kp]
        plain = [getattr(ps, n) for n in step_kernel._GRID_OUT +
                 step_kernel._DIM_OUT + step_kernel._FLAG_OUT] + \
            [ps.steps, ps.submit_count, ps.last_action_op, pr, pt, pp]
        assert len(outs) == len(offsets) == 20
        assert ks.last_reward is kr
        spans = []
        for out, ref, off in zip(outs, plain, offsets):
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert out.is_contiguous()
            assert out.data_ptr() == base + off and off % 256 == 0
            spans.append((off, off + out.numel() * out.element_size()))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        for name in ("input", "answer", "input_dim", "answer_dim",
                     "reset_on_submit"):
            assert getattr(ks, name) is getattr(st, name)


def test_misaligned_grid_raises():
    """Word-wide access needs each grid row on a 4-byte boundary: a grid
    that starts elsewhere is refused, not stepped."""
    table = raw_table()
    st = small_state(table, batch=2)
    shifted = torch.zeros(2 * 900 + 1, dtype=torch.int8)[1:].view(2, 30, 30)
    act = Action(selection=torch.zeros((2, 30, 30), dtype=torch.int8),
                 operation=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="4-byte"):
        step_kernel._launch(_RecordingLib(), st.replace(grid=shifted), act,
                            table, table.rows("cpu"), None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    return torch.device("cuda", 0)


# (table, grid side): the four tables at 30x30, and the 5x5 geometry of the
# answer-given suite
TABLES = {"o2arc": (lambda: o2arc_table(max_trial=3), 30),
          "o2arc_crop33": (lambda: o2arc_table(max_trial=3,
                                               crop_at_33=True), 30),
          "arc": (lambda: arc_table(max_trial=3), 30),
          "raw": (lambda: raw_table(max_trial=3), 30),
          "o2arc_5x5": (lambda: o2arc_table(max_trial=3), 5)}


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(TABLES))
def test_kernel_matches_plain_on_card(cuda_device, family):
    """The CUDA kernel against its plain version on the same CUDA inputs:
    every field, reward and terminated bit-exact, pending always False."""
    make_table, side = TABLES[family]
    table = make_table()
    batch = 512
    loader = SyntheticLoader(8, seed=0, min_size=2, max_size=min(side, 12))
    env = BatchedEnv(table=table,
                     bank=loader.bank(side, side, device=cuda_device),
                     max_trial=3,
                     opts=ResetOptions.make(
                         reset_on_submit=torch.arange(batch) % 3 == 0))
    st = env.reset(torch.Generator(device=cuda_device).manual_seed(0),
                   batch).env
    rng = np.random.default_rng(1)
    launches = step_kernel.LAUNCHES
    for t in range(15):
        a = fuzz_action(rng, batch, table.n_ops, side)
        act = Action(selection=a.selection.to(cuda_device),
                     operation=a.operation.to(cuda_device))
        ks, kr, kt, kp = cuda_step_deferred(st, act, table)
        ps, pr, pt, pp = plain_step_deferred(st, act, table)
        if bool(pp.any()):
            ps = finish_flood(ps, act, table, pp)
        torch.cuda.synchronize()
        for name in FIELDS:
            assert torch.equal(getattr(ks, name), getattr(ps, name)), \
                f"step {t} field {name}"
        assert torch.equal(kr, pr) and torch.equal(kt, pt), f"step {t}"
        assert not bool(kp.any())
        st = ps
    assert step_kernel.LAUNCHES == launches + 15


# (table, H, W): the 30x30 tables, the 5x5 geometry, and shapes for the
# instantiation with runtime H, W: non-square (12x20), an odd cell count
# (5x7), and wider than 32 columns, where the flood relaxes in shared
# memory (16x64)
ADVERSARIAL = {"o2arc": (lambda: o2arc_table(max_trial=3), 30, 30),
               "o2arc_crop33": (lambda: o2arc_table(max_trial=3,
                                                    crop_at_33=True), 30, 30),
               "arc": (lambda: arc_table(max_trial=3), 30, 30),
               "raw": (lambda: raw_table(max_trial=3), 30, 30),
               "o2arc_5x5": (lambda: o2arc_table(max_trial=3), 5, 5),
               "raw_12x20": (lambda: raw_table(max_trial=3), 12, 20),
               "arc_5x7": (lambda: arc_table(max_trial=3), 5, 7),
               "arc_16x64": (lambda: arc_table(max_trial=3), 16, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_kernel_matches_plain_adversarial_on_card(cuda_device, case):
    """The adversarial cases (corridor floods seeded at their far end, int8
    selections other than 0/1, object ops on envs holding an object,
    reset-on-submit rows) through the kernel and its plain version."""
    make_table, H, W = ADVERSARIAL[case]
    table = make_table()
    batch = 509                             # a ragged last block
    loader = SyntheticLoader(8, seed=0, min_size=2, max_size=min(H, W, 12))
    env = BatchedEnv(table=table, bank=loader.bank(H, W, device=cuda_device),
                     max_trial=3)
    st = env.reset(torch.Generator(device=cuda_device).manual_seed(0),
                   batch).env
    rng = np.random.default_rng(2)
    for name, s0, acts in step_cases(state_to_numpy(st), table, rng):
        s = state_from_numpy(s0, device=cuda_device)
        for t, (sel, ops) in enumerate(acts):
            act = Action(selection=torch.from_numpy(sel).to(cuda_device),
                         operation=torch.from_numpy(ops).to(cuda_device))
            ks, kr, kt, kp = cuda_step_deferred(s, act, table)
            ps, pr, pt, pp = plain_step_deferred(s, act, table)
            if bool(pp.any()):
                ps = finish_flood(ps, act, table, pp)
            torch.cuda.synchronize()
            for field in FIELDS:
                assert torch.equal(getattr(ks, field), getattr(ps, field)), \
                    f"{case} {name} step {t} field {field}"
            assert torch.equal(kr, pr) and torch.equal(kt, pt), \
                f"{case} {name} step {t}"
            assert not bool(kp.any())
            s = ps

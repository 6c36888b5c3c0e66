"""The step kernel's wrapper, and the kernel itself where a card exists.

Here on the CPU: the port imports no JAX, the wrappers of the step kernel
and of the engine epilogue take the plain versions for CPU tensors (and
only for them), and a missing CUDA toolkit raises instead of falling back.
The ``gpu`` tests hold both CUDA kernels to their plain versions bit for
bit; they skip without a card and run on one with
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

from arcle_tpu_torch.core import Action, FIELDS, init_state, \
    state_from_numpy, state_to_numpy
from arcle_tpu_torch.envs import BatchedEnv, ResetOptions, augment_task, \
    draw_augmentation
from arcle_tpu_torch.envs import core as env_core
from arcle_tpu_torch.envs.core import BatchedState, draw_reset
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


# ---- the engine epilogue ---------------------------------------------------

def _reset_before_split(bank, generator, opts, batch, max_trial=-1,
                        augment=False):
    """``envs/core.py::reset`` as it was written before its draw part was
    split off: the yardstick of the split."""
    dev = bank.device
    o = opts.rows(batch, dev)
    draw_task = torch.randint(0, bank.n_tasks, (batch,), generator=generator,
                              device=dev, dtype=torch.int32)
    draw_pair = torch.randint(0, 1 << 30, (batch,), generator=generator,
                              device=dev, dtype=torch.int32)
    prob = torch.where(o.prob_index >= 0, o.prob_index, draw_task)
    count = bank.pair_count(prob, o.adaptation)
    sub = torch.where(o.subprob_index >= 0, o.subprob_index,
                      draw_pair % torch.clamp(count, min=1))
    flat = bank.pair_index(prob, sub, o.adaptation).long()
    grid, dim = bank.in_grids[flat], bank.in_dims[flat]
    answer, answer_dim = bank.out_grids[flat], bank.out_dims[flat]
    if augment:
        k, perm = draw_augmentation(generator, batch, dev)
        grid, dim, answer, answer_dim = augment_task(grid, dim, answer,
                                                     answer_dim, k, perm)
    return init_state(grid, dim, answer, answer_dim, max_trial=max_trial,
                      reset_on_submit=o.reset_on_submit.to(torch.int8))


@pytest.mark.parametrize("pinned", [False, True], ids=["drawn", "pinned"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_split_reset_matches_reset(pinned, augment):
    """``reset`` split into its draw part and ``init_state`` returns what
    it returned before, field for field, from the same generator seed, and
    leaves the generator where it left it."""
    bank = SyntheticLoader(8, seed=0).bank(device="cpu")
    batch = 24
    opts = ResetOptions.make(
        prob_index=torch.arange(batch) % 8 if pinned else -1,
        subprob_index=torch.arange(batch) % 2 if pinned else -1,
        reset_on_submit=torch.arange(batch) % 3 == 0, device="cpu")
    gens = [torch.Generator().manual_seed(11) for _ in range(3)]
    want = _reset_before_split(bank, gens[0], opts, batch, 3, augment)
    got = env_core.reset(bank, gens[1], opts, batch, 3, augment)
    grid, dim, answer, answer_dim = draw_reset(bank, gens[2], opts, batch,
                                               augment)
    split = init_state(grid, dim, answer, answer_dim, max_trial=3,
                       reset_on_submit=opts.rows(
                           batch, "cpu").reset_on_submit.to(torch.int8))
    for name in FIELDS:
        w = getattr(want, name)
        for st in (got, split):
            g = getattr(st, name)
            assert g.dtype == w.dtype and torch.equal(g, w), name
    for g in gens[1:]:
        assert torch.equal(g.get_state(), gens[0].get_state())


def _epilogue_env(side, batch, source, shaping, limit, auto, device="cpu",
                  bank=None):
    """A ``BatchedEnv`` of the epilogue's tests: ``source`` is "pool" (K=3),
    "drawn" or "augment" (pool-less), ``shaping`` "dense", "pixel" (with
    terminate-on-match) or "none"; tasks pinned per env, so draws on two
    devices pick the same pairs."""
    if bank is None:
        bank = SyntheticLoader(8, seed=0, min_size=2,
                               max_size=min(side, 12)).bank(side, side,
                                                            device=device)
    opts = ResetOptions.make(prob_index=torch.arange(batch) % 8,
                             subprob_index=0,
                             reset_on_submit=torch.arange(batch) % 3 == 0,
                             device=device)
    return BatchedEnv(table=o2arc_table(max_trial=3), bank=bank, max_trial=3,
                      episode_limit=limit, auto_reset=auto,
                      dense_reward=shaping == "dense",
                      pixel_reward=shaping == "pixel",
                      terminate_on_match=shaping == "pixel",
                      augment=source == "augment",
                      reset_pool=3 if source == "pool" else 0, opts=opts)


def _steer(bs, rng):
    """A third of the envs put onto their answers, so matches happen."""
    e = bs.env
    m = torch.from_numpy(rng.random(e.batch) < 0.35).to(e.device)
    return dataclasses.replace(bs, env=e.replace(
        grid=torch.where(m[:, None, None], e.answer, e.grid),
        grid_dim=torch.where(m[:, None], e.answer_dim, e.grid_dim)))


@pytest.mark.parametrize("source,auto", [("pool", True), ("drawn", True),
                                         ("augment", True), ("pool", False)])
def test_epilogue_takes_plain_version_on_cpu(monkeypatch, source, auto):
    """CPU tensors run ``BatchedEnv.plain_epilogue``: the same carry, obs,
    reward, term and trunc, no build, no load, no launch."""
    def no_load():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(step_kernel, "load", no_load)
    before = step_kernel.EPILOGUE_LAUNCHES
    env = _epilogue_env(30, 16, source, "dense", 5, auto)
    bs = env.reset(torch.Generator().manual_seed(0), 16)
    rng = np.random.default_rng(0)
    for t in range(8):
        bs = _steer(bs, rng) if t % 3 == 1 else bs
        act = fuzz_action(rng, 16, env.table.n_ops)
        env2, reward, term = step_kernel.complete_step(bs.env, act,
                                                       env.table)
        gen = torch.Generator()
        gen.set_state(bs.generator.get_state())
        got = step_kernel.step_epilogue(env, bs, env2, reward, term)
        want = env.plain_epilogue(dataclasses.replace(bs, generator=gen),
                                  env2, reward, term)
        for name in FIELDS:
            for a, b in ((got[0].env, want[0].env), (got[1], want[1])):
                assert torch.equal(getattr(a, name), getattr(b, name)), name
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if source == "pool" and auto:
            assert torch.equal(got[0].pool.counter, want[0].pool.counter)
        bs = got[0]
    assert step_kernel.EPILOGUE_LAUNCHES == before


class _RecordingEpilogueLib:
    """Stands in for the kernel library: records the epilogue's launch."""

    def __init__(self):
        self.args = None

    def arcle_epilogue_launch(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("auto", [True, False], ids=["carry", "tail"])
def test_epilogue_outputs_are_aligned_views_of_one_arena(auto):
    """The epilogue's outputs: one arena, each view contiguous with the
    plain version's dtype and shape, on a 256-byte boundary, disjoint, at
    the byte offsets the kernel is given; the kernel is given the post-step
    state's fields, the fresh rows and the flags in its order."""
    for batch in (16, 13):                  # 13: a ragged last block
        env = _epilogue_env(30, batch, "pool", "pixel", 7, auto)
        bs = env.reset(torch.Generator().manual_seed(0), batch)
        act = fuzz_action(np.random.default_rng(0), batch, env.table.n_ops)
        env2, reward, term = step_kernel.complete_step(bs.env, act,
                                                       env.table)
        pool = bs.pool
        fresh = (pool.grid, pool.dim, pool.answer, pool.answer_dim,
                 pool.counter, env.reset_on_submit_i8) if auto else None
        lib = _RecordingEpilogueLib()
        before = step_kernel.EPILOGUE_LAUNCHES
        got = step_kernel._epilogue(lib, None, env, bs, env2, reward, term,
                                    fresh, 3 if auto else 0)
        assert step_kernel.EPILOGUE_LAUNCHES == before + 1
        want = env.plain_epilogue(bs, env2, reward, term)
        ptrs, base, offsets = lib.args[0], lib.args[1], list(lib.args[2])
        assert list(lib.args[3:14]) == [batch, 30, 30, 3 if auto else 0, 0,
                                        1, 1, int(auto), 7, 3,
                                        1 if auto else 0]
        names = step_kernel._ENV2_IN
        expect = [getattr(env2, n).data_ptr() for n in names] + \
            [reward.data_ptr(), term.data_ptr()] + \
            ([t.data_ptr() for t in fresh] if auto else [0] * 6)
        assert [p or 0 for p in ptrs] == expect
        outs = [got[2], got[3], got[4]]
        plain = [want[2], want[3], want[4]]
        where = offsets[24:]
        if auto:
            outs = [getattr(got[0].env, n) for n in names[:22]] + \
                [got[0].pool.counter, got[0].env.last_reward] + outs
            plain = [getattr(want[0].env, n) for n in names[:22]] + \
                [want[0].pool.counter, want[0].env.last_reward] + plain
            where = offsets
        else:
            assert offsets[:24] == [0] * 24
            assert got[0].env is env2 and got[0].pool is bs.pool
        assert len(offsets) == 27 and len(outs) == len(where)
        spans = []
        for out, ref, off in zip(outs, plain, where):
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert out.is_contiguous()
            assert out.data_ptr() == base + off and off % 256 == 0
            spans.append((off, off + out.numel() * out.element_size()))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert got[1] is env2


@pytest.mark.parametrize("fault", ["pool_rows", "ros_rows", "strided_input",
                                   "misaligned_pool", "none"])
def test_epilogue_refuses_what_the_kernel_does_not_take(monkeypatch, fault):
    """Past the device check, the epilogue's wrapper checks what the step
    kernel did not write (the carried fields, the pool, the
    reset_on_submit row) and raises on what the kernel does not take,
    before any launch; a sound carry launches once."""
    import contextlib
    import types
    lib = _RecordingEpilogueLib()
    monkeypatch.setattr(step_kernel, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    batch = 8
    env = _epilogue_env(30, batch, "pool", "dense", 5, True)
    bs = env.reset(torch.Generator().manual_seed(0), batch)
    act = fuzz_action(np.random.default_rng(0), batch, env.table.n_ops)
    env2, reward, term = step_kernel.complete_step(bs.env, act, env.table)
    if fault == "pool_rows":
        bs = dataclasses.replace(bs, pool=dataclasses.replace(
            bs.pool, grid=bs.pool.grid[:-1], answer=bs.pool.answer[:-1]))
    elif fault == "ros_rows":
        object.__setattr__(env, "reset_on_submit_i8",
                           torch.zeros(batch + 1, dtype=torch.int8))
    elif fault == "strided_input":
        env2 = env2.replace(input=env2.input.transpose(1, 2))
    elif fault == "misaligned_pool":
        g = bs.pool.grid
        shifted = torch.zeros(g.numel() + 1, dtype=torch.int8)[1:].view(
            g.shape)
        bs = dataclasses.replace(bs, pool=dataclasses.replace(
            bs.pool, grid=shifted))
    if fault == "none":
        step_kernel._checked_epilogue(env, bs, env2, reward, term)
        assert lib.args is not None
    else:
        with pytest.raises(ValueError):
            step_kernel._checked_epilogue(env, bs, env2, reward, term)
        assert lib.args is None


class _HostAugmentation:
    """``draw_augmentation`` from one CPU generator per device type, so the
    card and the CPU draw the same rotations and permutations."""

    def __init__(self, seed):
        self.seed, self.gens = seed, {}

    def __call__(self, generator, batch, device, colors=10):
        key = torch.device(device).type
        if key not in self.gens:
            self.gens[key] = torch.Generator().manual_seed(self.seed)
        k, perm = draw_augmentation(self.gens[key], batch, "cpu", colors)
        return k.to(device), perm.to(device)


EPILOGUE_SIZES = {"30x30_B256": (30, 256), "5x5_B1024": (5, 1024)}


@pytest.mark.gpu
@pytest.mark.parametrize("auto", [True, False], ids=["reset", "noreset"])
@pytest.mark.parametrize("limit", [0, 12])
@pytest.mark.parametrize("shaping", ["dense", "pixel", "none"])
@pytest.mark.parametrize("source", ["pool", "drawn", "augment"])
@pytest.mark.parametrize("size", sorted(EPILOGUE_SIZES))
def test_epilogue_matches_plain_on_card(cuda_device, monkeypatch, size,
                                        source, shaping, limit, auto):
    """``BatchedEnv.step`` on the card (step kernel, then the epilogue
    kernel) against the same env on the CPU (both plain), from the same
    state and pool with the same actions: every obs and carry field, the
    reward's bits, term, trunc and the pool counter equal; one epilogue
    launch a step."""
    side, batch = EPILOGUE_SIZES[size]
    env_c = _epilogue_env(side, batch, source, shaping, limit, auto)
    env_g = _epilogue_env(side, batch, source, shaping, limit, auto,
                          device=cuda_device,
                          bank=env_c.bank.to(cuda_device))
    bs_c = env_c.reset(torch.Generator().manual_seed(3), batch)
    # from here on, both devices draw the same augmentations
    monkeypatch.setattr(env_core, "draw_augmentation", _HostAugmentation(5))
    to = lambda s: type(s)(**{f.name: getattr(s, f.name).to(cuda_device)
                              for f in dataclasses.fields(s)})
    bs_g = BatchedState(env=to(bs_c.env),
                        generator=torch.Generator(device=cuda_device),
                        pool=None if bs_c.pool is None else to(bs_c.pool))
    rng = np.random.default_rng(4)
    launches, done = step_kernel.EPILOGUE_LAUNCHES, 0
    for t in range(16):
        if t % 3 == 1:
            steer = np.random.default_rng(100 + t)
            bs_c, bs_g = _steer(bs_c, steer), _steer(bs_g, np.random.
                                                     default_rng(100 + t))
        a = fuzz_action(rng, batch, env_c.table.n_ops, side)
        act = Action(selection=a.selection.to(cuda_device),
                     operation=a.operation.to(cuda_device))
        bs_g, obs_g, r_g, te_g, tr_g = env_g.step(bs_g, act)
        bs_c, obs_c, r_c, te_c, tr_c = env_c.step(bs_c, a)
        torch.cuda.synchronize()
        assert torch.equal(r_g.cpu().view(torch.int32),
                           r_c.view(torch.int32)), f"step {t} reward"
        for name, g, c in (("term", te_g, te_c), ("trunc", tr_g, tr_c)):
            assert g.dtype == c.dtype and torch.equal(g.cpu(), c), \
                f"step {t} {name}"
        for f in FIELDS:
            for what, g, c in (("obs", obs_g, obs_c),
                               ("carry", bs_g.env, bs_c.env)):
                x, y = getattr(g, f).cpu(), getattr(c, f)
                assert x.dtype == y.dtype and torch.equal(x, y), \
                    f"step {t} {what}.{f}"
        if bs_c.pool is not None:
            assert torch.equal(bs_g.pool.counter.cpu(), bs_c.pool.counter)
        done += int((te_c | tr_c).sum())
    assert step_kernel.EPILOGUE_LAUNCHES == launches + 16
    if limit or shaping == "pixel":
        assert done > 0

"""``arcle_tpu_torch.core`` against ``arcle_tpu.core`` on the same inputs.

State, geometry and flood fill are integer or boolean throughout, so every
comparison is bit-exact.  Inputs are made from a seed with numpy; the JAX
side runs its single-env functions under ``jax.vmap``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from arcle_tpu.core import floodfill as jflood
from arcle_tpu.core import geometry as jgeo
from arcle_tpu.core import state as jstate

from arcle_tpu_torch.core import floodfill as tflood
from arcle_tpu_torch.core import geometry as tgeo
from arcle_tpu_torch.core import state as tstate

B, H, W = 48, 30, 30
t = torch.from_numpy


def np_of(x):
    return np.asarray(x)


def test_init_and_empty_state_match():
    rng = np.random.default_rng(0)
    grids = rng.integers(0, 10, (B, H, W)).astype(np.int8)
    answers = rng.integers(0, 10, (B, H, W)).astype(np.int8)
    dims = rng.integers(1, 31, (B, 2)).astype(np.int8)
    adims = rng.integers(1, 31, (B, 2)).astype(np.int8)
    ros = (rng.random(B) < 0.5).astype(np.int8)
    js = jax.vmap(lambda g, d, a, ad, r: jstate.init_state(
        g, d, a, ad, max_trial=3, reset_on_submit=r))(
        grids, dims, answers, adims, ros)
    ts = tstate.init_state(t(grids), t(dims), t(answers), t(adims),
                           max_trial=3, reset_on_submit=t(ros))
    for name in tstate.FIELDS:
        np.testing.assert_array_equal(np_of(getattr(js, name)),
                                      getattr(ts, name).numpy(),
                                      err_msg=name)
    je = jstate.empty_state(H, W, max_trial=-1)
    te = tstate.empty_state(2, H, W, max_trial=-1)
    for name in tstate.FIELDS:
        j = np_of(getattr(je, name))
        np.testing.assert_array_equal(np.broadcast_to(j, (2,) + j.shape),
                                      getattr(te, name).numpy(), err_msg=name)


def test_state_numpy_round_trip():
    rng = np.random.default_rng(1)
    js = jax.vmap(lambda g, d: jstate.init_state(g, d, g, d, max_trial=-1))(
        rng.integers(0, 10, (4, H, W)).astype(np.int8),
        rng.integers(1, 31, (4, 2)).astype(np.int8))
    ts = tstate.state_from_numpy(js)
    back = tstate.state_to_numpy(ts)
    for f in dataclasses.fields(js):
        a = np_of(getattr(js, f.name))
        assert back[f.name].dtype == a.dtype, f.name
        np.testing.assert_array_equal(back[f.name], a, err_msg=f.name)
    # a state carried across keeps its bits: no silent dtype conversion
    bad = dict(back, grid=back["grid"].astype(np.int32))
    with pytest.raises(TypeError):
        tstate.state_from_numpy(bad)


def test_selections_match():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 30, (4, B)).astype(np.int32)
    jb = jax.vmap(jgeo.bbox_selection, in_axes=(0, 0, 0, 0, None, None))(
        c[0], c[1], c[2], c[3], H, W)
    jbf = jax.vmap(jgeo.bbox_selection_flat,
                   in_axes=(0, 0, 0, 0, None, None))(c[0], c[1], c[2], c[3],
                                                     H, W)
    jp = jax.vmap(jgeo.point_selection, in_axes=(0, 0, None, None))(
        c[0], c[1], H, W)
    jpf = jax.vmap(jgeo.point_selection_flat, in_axes=(0, 0, None, None))(
        c[0], c[1], H, W)
    tc = t(c)
    np.testing.assert_array_equal(
        np_of(jb), tgeo.bbox_selection(tc[0], tc[1], tc[2], tc[3], H, W))
    np.testing.assert_array_equal(
        np_of(jbf), tgeo.bbox_selection_flat(tc[0], tc[1], tc[2], tc[3], H, W))
    np.testing.assert_array_equal(
        np_of(jp), tgeo.point_selection(tc[0], tc[1], H, W))
    np.testing.assert_array_equal(
        np_of(jpf), tgeo.point_selection_flat(tc[0], tc[1], H, W))


def test_bbox_dims_and_windows_match():
    rng = np.random.default_rng(3)
    masks = (rng.random((B, H, W)) < 0.02).astype(np.int8)
    masks[::5] = 0                      # some empty masks
    jr = jax.vmap(jgeo.bbox)(masks)
    tr = tgeo.bbox(t(masks))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np_of(a), b.numpy())
    dims = rng.integers(-3, 33, (B, 2)).astype(np.int8)
    np.testing.assert_array_equal(
        np_of(jax.vmap(jgeo.inside_dims, in_axes=(0, None, None))(
            dims, H, W)), tgeo.inside_dims(t(dims), H, W).numpy())
    x, y, h, w = rng.integers(-40, 40, (4, B)).astype(np.int32)
    np.testing.assert_array_equal(
        np_of(jax.vmap(jgeo.window_mask,
                       in_axes=(0, 0, 0, 0, None, None))(x, y, h, w, H, W)),
        tgeo.window_mask(t(x), t(y), t(h), t(w), H, W).numpy())


def test_shift_and_place_patch_negative_offsets():
    """Signed placements, partly or wholly off-grid, as the JAX package's
    roll-based placement: values over the whole grid and the window."""
    rng = np.random.default_rng(4)
    patch = rng.integers(0, 10, (B, H, W)).astype(np.int8)
    h, w = rng.integers(1, 31, (2, B)).astype(np.int32)
    x, y = rng.integers(-45, 45, (2, B)).astype(np.int32)
    lh, lw = rng.integers(0, 31, (2, B)).astype(np.int32)
    jv, jm = jax.vmap(jgeo.place_patch)(patch, h, w, x, y, lh, lw)
    tv, tm = tgeo.place_patch(t(patch), t(h), t(w), t(x), t(y), t(lh), t(lw))
    np.testing.assert_array_equal(np_of(jv), tv.numpy())
    np.testing.assert_array_equal(np_of(jm), tm.numpy())
    assert (x < 0).any() and (y < 0).any()
    js = jax.vmap(jgeo.shift2d)(patch, x, y)
    np.testing.assert_array_equal(np_of(js),
                                  tgeo.shift2d(t(patch), t(x), t(y)).numpy())


def serpentine():
    """Color-1 corridor of 15 legs joined alternately at the ends."""
    g = np.full((H, W), 2, np.int8)
    for r in range(0, H, 2):
        g[r, :] = 1
    for i, r in enumerate(range(1, H - 1, 2)):
        g[r, W - 1 if i % 2 == 0 else 0] = 1
    return g


@pytest.mark.parametrize("case", ["random", "serpentine"])
def test_connected_component_matches(case):
    rng = np.random.default_rng(5)
    if case == "random":
        region = rng.random((B, H, W)) < 0.55
    else:
        region = np.broadcast_to(serpentine() == 1, (B, H, W)).copy()
    seeds = np.zeros((B, H, W), bool)
    rows = rng.integers(0, H, B) if case == "random" else np.zeros(B, int)
    seeds[np.arange(B), rows, rng.integers(0, W, B)] = True
    jc = jax.vmap(jflood.connected_component)(region, seeds)
    tc = tflood.connected_component(t(region), t(seeds))
    np.testing.assert_array_equal(np_of(jc), tc.numpy())
    for unroll in (1, 2):
        jm, jconv = jax.vmap(
            lambda r, s: jflood.connected_component_partial(r, s, unroll))(
            region, seeds)
        tm, tconv = tflood.connected_component_partial(t(region), t(seeds),
                                                       unroll)
        np.testing.assert_array_equal(np_of(jm), tm.numpy())
        np.testing.assert_array_equal(np_of(jconv), tconv.numpy())
    js = jax.vmap(jflood.sweep)(seeds & region, region)
    np.testing.assert_array_equal(
        np_of(js), tflood.sweep(t(seeds & region), t(region)).numpy())
    if case == "serpentine":
        # seeds on row 0: the corridor needs far more than two sweeps
        assert not tconv.any()
        assert (tc.numpy() == region).all()


def test_flood_region_matches():
    rng = np.random.default_rng(6)
    grids = rng.integers(0, 3, (B, H, W)).astype(np.int8)
    dims = rng.integers(1, 31, (B, 2)).astype(np.int8)
    x = (rng.integers(0, 30, B) % dims[:, 0]).astype(np.int32)
    y = (rng.integers(0, 30, B) % dims[:, 1]).astype(np.int32)
    jr = jax.vmap(jflood.flood_region)(grids, dims, x, y)
    tr = tflood.flood_region(t(grids), t(dims), t(x), t(y))
    np.testing.assert_array_equal(np_of(jr), tr.numpy())

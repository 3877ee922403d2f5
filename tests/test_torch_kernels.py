"""The plain versions of the port's five kernels (B1 gsweep.sweep0, B2
gsweep.sweep0_dual, B3 crop_argmax, B4 sweep.sweep_axis0_batched, B5
sweep.sweep_axis0) against the JAX package on the same seeded inputs, bit
for bit.

On CPU tensors each wrapper runs its plain torch version, so these tests
pin the semantics every CUDA kernel is compared with on the card
(chip_smoke.py, tests/test_torch_gpu.py). The JAX side runs as its own
tests run it on the CPU: the scan forms, or Pallas in interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kimimaro_tpu import gengine as jgengine
from kimimaro_tpu.ops import gsweep as jgsweep
from kimimaro_tpu.ops import pallas_sweep
from kimimaro_tpu.ops.stencils import GRAPH_BITS
from kimimaro_tpu_torch.ops import crop_argmax as tcrop
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)
SHAPE = (11, 9, 8)


@pytest.fixture
def interpret():
    prev = pallas_sweep.INTERPRET
    pallas_sweep.INTERPRET = True
    yield
    pallas_sweep.INTERPRET = prev


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _sweep_inputs(mode, has_ok, clamp, seed):
    rng = np.random.RandomState(seed)
    cc = rng.randint(0, 4, size=SHAPE).astype(np.int32)
    if mode == "minid":
        # raw labels bitcast to int32 may be negative: occupancy is != 0
        cc[cc == 3] = -7
        d = np.where(cc != 0, rng.randint(1, 999, size=SHAPE),
                     2**31 - 1).astype(np.int32)
    elif mode == "maxflood":
        d = np.where(cc > 0, rng.rand(*SHAPE) * 10, -np.inf)
    else:
        d = np.where(rng.rand(*SHAPE) < 0.25,
                     rng.rand(*SHAPE) * 10 - (5.0 if clamp else 0.0), np.inf)
    d = d.astype(np.int32 if mode == "minid" else np.float32)
    nc = (rng.rand(*SHAPE) * 3).astype(np.float32) if mode == "node" else None
    ok = (rng.rand(*SHAPE) < 0.8).astype(np.uint8) if has_ok else None
    return d, cc, nc, ok


@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("clamp", (False, True))
@pytest.mark.parametrize("has_ok", (False, True))
@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood", "minid"))
def test_sweep0_matches_jax_scan(mode, has_ok, clamp, descending):
    """B1's plain version equals gsweep._sweep0_scan in every mode and
    option, including the plane-0 pass-through, minid's != 0 occupancy
    and the clamp."""
    d, cc, nc, ok = _sweep_inputs(mode, has_ok, clamp, seed=len(mode))
    want = np.asarray(jgsweep._sweep0_scan(
        _j(d), _j(cc), _j(nc), _j(ok), ANIS, mode, clamp, descending))
    got = tgsweep.sweep0(_t(d), _t(cc), _t(nc), _t(ok), ANIS, mode, clamp,
                         descending)
    assert got.dtype == (torch.int32 if mode == "minid" else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("kind", ("ball_rail", "max2"))
def test_sweep0_dual_matches_pallas_interpret(interpret, kind, descending):
    """B2's plain version equals the JAX dual kernel (interpret mode),
    including ball_rail's okmask folded into field A's carried values."""
    rng = np.random.RandomState(5)
    cc = rng.randint(0, 4, size=SHAPE).astype(np.int32)
    if kind == "ball_rail":
        da = np.where(rng.rand(*SHAPE) < 0.2, -rng.rand(*SHAPE) * 60, np.inf)
        db = np.where(rng.rand(*SHAPE) < 0.2, rng.rand(*SHAPE), np.inf)
        nc = (rng.rand(*SHAPE) * 3).astype(np.float32)
        ok = (rng.rand(*SHAPE) < 0.8).astype(np.uint8)
    else:
        da = np.where(cc > 0, rng.rand(*SHAPE) * 10, -np.inf)
        db = np.where(cc > 0, rng.rand(*SHAPE) * 10, -np.inf)
        nc = ok = None
    da, db = da.astype(np.float32), db.astype(np.float32)
    want = jgsweep._sweep0_pallas_dual(_j(da), _j(db), _j(cc), _j(nc), _j(ok),
                                       ANIS, kind, descending)
    got = tgsweep.sweep0_dual(_t(da), _t(db), _t(cc), _t(nc), _t(ok), ANIS,
                              kind, descending)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("clamp", (False, True))
@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_matches_pallas_interpret(interpret, node_mode, clamp,
                                              descending):
    """B5's plain version equals pallas_sweep.sweep_axis0 (interpret
    mode); a descending sweep equals the ascending kernel on flipped
    planes."""
    rng = np.random.RandomState(11)
    d = np.where(rng.rand(*SHAPE) < 0.25,
                 rng.rand(*SHAPE) * 10 - (5.0 if clamp else 0.0),
                 np.inf).astype(np.float32)
    ok = rng.rand(*SHAPE) < 0.8
    nc = (rng.rand(*SHAPE) * 3).astype(np.float32)
    flip = (lambda a: a[::-1].copy()) if descending else (lambda a: a)
    want = flip(np.asarray(pallas_sweep.sweep_axis0(
        _j(flip(d)), _j(flip(ok)), _j(flip(nc)), ANIS, node_mode, clamp)))
    got = tsweep.sweep_axis0(_t(d), _t(ok), _t(nc), ANIS, node_mode, clamp,
                             descending=descending)
    np.testing.assert_array_equal(got.numpy(), want)


def _voxel_graph(rng, shape):
    """Random symmetric walls (tests/test_pallas_sweep.py:143): each
    directed edge dropped with p = 0.3, and with it the neighbour's
    reverse bit."""
    vg = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    for off, bit in GRAPH_BITS.items():
        rev = GRAPH_BITS[tuple(-o for o in off)]
        drop = rng.rand(*shape) < 0.3
        vg &= ~np.where(drop, np.uint32(1 << bit), np.uint32(0))
        src, dst = [slice(None)], [slice(None)]
        for o, n in zip(off, shape[1:]):
            src.append(slice(o, n) if o >= 0 else slice(0, n + o))
            dst.append(slice(0, n - o) if o >= 0 else slice(-o, n))
        sub = np.zeros(shape, bool)
        sub[tuple(src)] = drop[tuple(dst)]
        vg &= ~np.where(sub, np.uint32(1 << rev), np.uint32(0))
    return vg


@pytest.mark.parametrize("graph", (False, True))
@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("clamp", (False, True))
@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_batched_matches_pallas_interpret(interpret, node_mode,
                                                      clamp, descending,
                                                      graph):
    """B4's plain version equals pallas_sweep.sweep_axis0_batched
    (interpret mode) over lanes, with and without voxel-graph gating on
    the neighbour's bits (the bit table of a descending z sweep)."""
    rng = np.random.RandomState(13)
    shape = (3,) + SHAPE
    d = np.where(rng.rand(*shape) < 0.25,
                 rng.rand(*shape) * 10 - (5.0 if clamp else 0.0),
                 np.inf).astype(np.float32)
    ok = rng.rand(*shape) < 0.8
    nc = (rng.rand(*shape) * 3).astype(np.float32)
    vg = bits9 = None
    if graph:
        vg = _voxel_graph(rng, shape)
        bits9 = tuple(GRAPH_BITS[(-dy, -dz, -1)] for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1))
    want = np.asarray(pallas_sweep.sweep_axis0_batched(
        _j(d), _j(ok), _j(nc), ANIS, node_mode, clamp, descending=descending,
        vg=_j(vg), bits9=bits9))
    got = tsweep.sweep_axis0_batched(_t(d), _t(ok), _t(nc), ANIS, node_mode,
                                     clamp, descending=descending, vg=_t(vg),
                                     bits9=bits9)
    np.testing.assert_array_equal(got.numpy(), want)


def _argmax_case(seed):
    """Quantized field (frequent ties), -inf voxels, an empty lane (lid
    absent) and a lane of background; crops clamped at the far edge."""
    rng = np.random.RandomState(seed)
    shape = (20, 18, 16)
    crop = (8, 7, 6)
    cc = rng.randint(0, 5, size=shape).astype(np.int32)
    field = np.round(rng.rand(*shape) * 3).astype(np.float32)
    field[rng.rand(*shape) < 0.3] = -np.inf
    field[cc == 4] = -np.inf  # label 4 holds only -inf
    offs = np.array([[0, 0, 0], [4, 2, 1], [12, 11, 10], [3, 3, 3],
                     [7, 5, 9], [1, 8, 2]], dtype=np.int32)
    lids = np.array([1, 2, 3, 9, 4, 0], dtype=np.int32)
    return field, cc, offs, lids, crop


@pytest.mark.parametrize("seed", (0, 1))
def test_crop_argmax_matches_jax(seed):
    """B3's plain version equals gengine._crop_argmax: first maximum in
    (x, y, z) order, -inf at the crop origin for empty lanes."""
    field, cc, offs, lids, crop = _argmax_case(seed)
    idx, val = jgengine._crop_argmax(_j(field), _j(cc).astype(jnp.uint16),
                                     _j(offs), _j(lids), crop)
    want_c = np.asarray(jgengine._unflatten_crop(idx, _j(offs), crop))
    got_c, got_v = tcrop.crop_argmax(_t(field), _t(cc), _t(offs), _t(lids),
                                     crop)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(val))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert np.isneginf(got_v.numpy()[3:5]).all()
    np.testing.assert_array_equal(got_c.numpy()[3], offs[3])


def test_crop_argmax_rejects_window_outside_volume():
    field, cc, offs, lids, crop = _argmax_case(0)
    offs[2] = (13, 0, 0)
    with pytest.raises(ValueError):
        tcrop.crop_argmax(_t(field), _t(cc), _t(offs), _t(lids), crop)

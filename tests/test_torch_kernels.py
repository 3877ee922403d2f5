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


def _label_boxes(cc, offs, lids, crop, rng, slack=0):
    """Per lane the bounding box of cc == lid inside the window, grown by
    up to `slack` cells on each side (kept inside the window); a lane
    without such a voxel gets a size-0 box at the window origin."""
    box_off = offs.copy()
    box_size = np.zeros_like(offs)
    for i, (o, lid) in enumerate(zip(offs, lids)):
        win = cc[o[0]:o[0] + crop[0], o[1]:o[1] + crop[1],
                 o[2]:o[2] + crop[2]]
        pts = np.argwhere(win == lid)
        if len(pts) == 0:
            continue
        lo = np.maximum(pts.min(axis=0) - rng.randint(0, slack + 1, 3), 0)
        hi = np.minimum(pts.max(axis=0) + 1 + rng.randint(0, slack + 1, 3),
                        crop)
        box_off[i] = o + lo
        box_size[i] = hi - lo
    return box_off.astype(np.int32), box_size.astype(np.int32)


def _argmax_variant(name):
    """The seeded case with the field rewritten to stress one rule."""
    field, cc, offs, lids, crop = _argmax_case(3)
    rng = np.random.RandomState(17)
    if name == "ties":
        # one value over every label: the first voxel in (x, y, z) wins,
        # across x, across y and across z
        field[:] = 2.0
    elif name == "signed_zero":
        field = np.where(rng.rand(*field.shape) < 0.5, -0.0, 0.0)
        field = field.astype(np.float32)
        field[cc == 4] = -np.inf
    elif name == "negative":
        field = -np.round(rng.rand(*field.shape) * 3 + 1).astype(np.float32)
        field[cc == 4] = -np.inf
    elif name == "all_neg_inf":
        field[:] = -np.inf
    return field, cc, offs, lids, crop


@pytest.mark.parametrize("slack", (0, 2))
@pytest.mark.parametrize("name", ("random", "ties", "signed_zero",
                                  "negative", "all_neg_inf"))
def test_crop_argmax_boxes_match_windows_and_jax(name, slack):
    """B3 over per-lane boxes that hold the label equals B3 over the whole
    windows and gengine._crop_argmax, bit for bit: -inf-only labels, absent
    ids (size-0 boxes), ties across x, y and z, -0.0 against 0.0."""
    field, cc, offs, lids, crop = _argmax_variant(name)
    rng = np.random.RandomState(5)
    boxes = _label_boxes(cc, offs, lids, crop, rng, slack)
    assert (boxes[1][3] == 0).all()  # the absent id scans nothing
    idx, val = jgengine._crop_argmax(_j(field), _j(cc).astype(jnp.uint16),
                                     _j(offs), _j(lids), crop)
    want_c = np.asarray(jgengine._unflatten_crop(idx, _j(offs), crop))
    want_v = np.asarray(val)
    args = (_t(field), _t(cc), _t(offs), _t(lids), crop)
    for got_c, got_v in (tcrop.crop_argmax(*args),
                         tcrop.crop_argmax(*args, boxes=(_t(boxes[0]),
                                                         _t(boxes[1])))):
        np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                      want_v.view(np.int32))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        np.testing.assert_array_equal(got_c.numpy()[3], offs[3])


def test_crop_argmax_first_maximum_across_each_axis():
    """Two equal maxima that differ along one axis only: the smaller
    coordinate wins on every axis, inside a box that starts elsewhere."""
    cc = np.ones((9, 8, 7), dtype=np.int32)
    offs = np.zeros((3, 3), dtype=np.int32)
    lids = np.ones(3, dtype=np.int32)
    crop = (9, 8, 7)
    for axis in range(3):
        field = np.zeros(cc.shape, dtype=np.float32)
        a, b = [4, 4, 4], [4, 4, 4]
        a[axis], b[axis] = 2, 5
        field[tuple(a)] = field[tuple(b)] = 7.0
        box = (_t(np.tile(np.int32([1, 2, 1]), (3, 1))),
               _t(np.tile(np.int32([7, 5, 5]), (3, 1))))
        got_c, got_v = tcrop.crop_argmax(_t(field), _t(cc), _t(offs),
                                         _t(lids), crop, boxes=box)
        np.testing.assert_array_equal(got_c.numpy(), np.tile(a, (3, 1)))
        np.testing.assert_array_equal(got_v.numpy(), np.float32([7, 7, 7]))


def test_crop_argmax_rejects_box_outside_window():
    field, cc, offs, lids, crop = _argmax_case(0)
    rng = np.random.RandomState(0)
    box_off, box_size = _label_boxes(cc, offs, lids, crop, rng)
    box_size[1] = (9, 2, 2)  # wider than the window's 8
    with pytest.raises(ValueError):
        tcrop.crop_argmax(_t(field), _t(cc), _t(offs), _t(lids), crop,
                          boxes=(_t(box_off), _t(box_size)))


@pytest.mark.parametrize("seed", (0, 1))
def test_grouped_argmax_one_call_equals_per_tier(seed):
    """gengine._grouped_argmax (one B3 call over the lanes of every tier,
    each scanning its label's bbox, padding lanes scanning nothing) equals
    one crop_argmax per tier over the whole tier crops, and the JAX
    package's per-tier form."""
    from kimimaro_tpu_torch import gengine as tgengine

    rng = np.random.RandomState(seed)
    shape = (40, 36, 30)
    cc = np.zeros(shape, dtype=np.int32)
    # labels of three sizes, so that three tiers hold lanes
    blocks = [((2, 3, 1), (6, 5, 4)), ((20, 2, 2), (7, 7, 6)),
              ((30, 25, 20), (5, 6, 7)), ((4, 12, 8), (14, 12, 10)),
              ((22, 14, 12), (12, 15, 13)), ((1, 26, 14), (30, 9, 15))]
    for lab, (o, s) in enumerate(blocks, start=1):
        m = rng.rand(*s) < 0.8
        m[0, 0, 0] = m[-1, -1, -1] = True
        cc[o[0]:o[0] + s[0], o[1]:o[1] + s[1], o[2]:o[2] + s[2]][m] = lab
    field = np.round(rng.rand(*shape) * 4).astype(np.float32)
    field[rng.rand(*shape) < 0.2] = -np.inf
    field[cc == 3] = -np.inf
    tiers = [(8, 8, 8), (16, 16, 16), (32, 16, 16)]
    groups, lids, offs, crops, box_off, box_size = [], [], [], [], [], []
    for t, members in enumerate(((1, 2, 3), (4, 5), (6,))):
        start = len(lids)
        for lab in members:
            o, s = blocks[lab - 1]
            lids.append(lab)
            offs.append(np.maximum(np.minimum(
                o, np.array(shape) - tiers[t]), 0))
            box_off.append(o)
            box_size.append(s)
        for _ in range(tgengine._lane_bucket(len(members)) - len(members)):
            lids.append(0)  # a padding lane
            offs.append((0, 0, 0))
            box_off.append((0, 0, 0))
            box_size.append((0, 0, 0))
        crops.extend([tiers[t]] * (len(lids) - start))
        groups.append((start, len(lids), tiers[t]))
    lids = np.int32(lids)
    offs, crops = np.int32(offs), np.int32(crops)
    box_off, box_size = np.int32(box_off), np.int32(box_size)
    assert len(lids) == 12 and (lids == 0).sum() == 6

    got_c, got_v = tgengine._grouped_argmax(
        _t(field), _t(cc), _t(offs), _t(lids), _t(crops),
        (_t(box_off), _t(box_size)))
    tier_c, tier_v = [], []
    for a, b, crop in groups:
        c, v = tcrop.crop_argmax(_t(field), _t(cc), _t(offs[a:b]),
                                 _t(lids[a:b]), crop)
        tier_c.append(c)
        tier_v.append(v)
    tier_c, tier_v = torch.cat(tier_c), torch.cat(tier_v)
    live = lids > 0
    # a padding lane's label 0 is the background, which the per-tier form
    # scans and the one call does not; the engine never reads those rows
    np.testing.assert_array_equal(got_v.numpy()[live], tier_v.numpy()[live])
    np.testing.assert_array_equal(got_c.numpy()[live], tier_c.numpy()[live])
    assert np.isneginf(got_v.numpy()[~live]).all()
    np.testing.assert_array_equal(got_c.numpy()[~live], offs[~live])
    jax_c, jax_v = jgengine._grouped_argmax(
        _j(field), _j(cc).astype(jnp.uint16), _j(offs), _j(lids), groups)
    np.testing.assert_array_equal(got_v.numpy()[live],
                                  np.asarray(jax_v)[live])
    np.testing.assert_array_equal(got_c.numpy()[live],
                                  np.asarray(jax_c)[live])
    assert np.isneginf(got_v.numpy()[2])  # label 3 holds only -inf

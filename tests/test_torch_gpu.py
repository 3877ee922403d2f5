"""The port's CUDA kernels against their plain torch versions on the card,
and the main path on CUDA against the main path on the CPU.

Marked `gpu`: they skip where torch sees no CUDA device. This file imports
no JAX, so it also runs on a machine with the card and without JAX:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

import kimimaro_tpu_torch
from kimimaro_tpu_torch import kernels
from kimimaro_tpu_torch.ops import chase as tchase
from kimimaro_tpu_torch.ops import crop_argmax as tcrop
from kimimaro_tpu_torch.ops import geodesic as tgeodesic
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops import stencils as tstencils
from kimimaro_tpu_torch.ops import sweep as tsweep
from kimimaro_tpu_torch.ops.stencils import GRAPH_BITS

pytestmark = pytest.mark.gpu

ANIS = (16.0, 16.0, 40.0)
SHAPE = (13, 37, 45)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, shape=SHAPE):
    return torch.rand(shape, generator=gen, device="cuda")


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), int((g != w).sum())


def _sweep0_inputs(gen, shape, mode):
    cc = torch.randint(0, 4, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    if mode == "minid":
        # raw labels bitcast to int32: -1 equals the carried id of an
        # unoccupied voxel in the plain version
        cc = torch.where(cc == 3, -7, torch.where(cc == 2, -1, cc))
        d = torch.where(cc != 0, (_rand(gen, shape) * 999).to(torch.int32)
                        + 1, 2**31 - 1).to(torch.int32)
    elif mode == "maxflood":
        d = torch.where(cc > 0, _rand(gen, shape) * 10, float("-inf"))
    else:
        d = torch.where(_rand(gen, shape) < 0.25, _rand(gen, shape) * 10 - 5,
                        float("inf"))
    nc = _rand(gen, shape) * 3 if mode == "node" else None
    ok = (_rand(gen, shape) < 0.8).to(torch.uint8)
    return d, cc, nc, ok


# B1's strips: n = 1 and 2, H = 1, H = 5, a last strip shorter than the
# others (H = 301 is strips of 3 rows on 132 SMs), W = 1, W = 33 (rows off
# the 16-byte grid), rotated non-cubic layouts
B1_SHAPES = ((11, 9, 8), SHAPE, (1, 7, 16), (2, 9, 16), (5, 1, 48),
             (6, 5, 32), (6, 301, 48), (7, 12, 1), (5, 20, 33),
             (24, 512, 128), (9, 128, 512))


@pytest.mark.parametrize("shape", B1_SHAPES)
@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood", "minid"))
def test_sweep0_kernel_matches_plain(gen, mode, shape):
    d, cc, nc, ok = _sweep0_inputs(gen, shape, mode)
    for okmask in (None, ok):
        for clamp in (False, True):
            for desc in (False, True):
                before = kernels.LAUNCHES["gsweep_sweep0"]
                got = tgsweep.sweep0(d, cc, nc, okmask, ANIS, mode, clamp,
                                     desc)
                assert kernels.LAUNCHES["gsweep_sweep0"] == before + 1
                again = tgsweep.sweep0(d, cc, nc, okmask, ANIS, mode, clamp,
                                       desc)
                want = tgsweep._sweep0_plain(d, cc, nc, okmask, ANIS, mode,
                                             clamp, desc)
                _assert_bit_equal((got,), (want,))
                _assert_bit_equal((again,), (got,))


def _smem_limit(mode, has_ok, persistent):
    """The square plane on each side of B1's shared-memory rule on a
    132-SM card with 227 KB a block."""
    side = {("node", False): (784, 800), ("node", True): (784, 800),
            (None, True): (848, 864), (None, False): (896, 912)}
    key = (mode if mode == "node" else None, has_ok)
    return side[key][0 if persistent else 1]


@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood", "minid"))
def test_sweep0_plan_follows_the_shape_rule(gen, mode):
    """One persistent launch per sweep where a strip of ceil(H / SMs) rows
    fits in shared memory, the per-plane form above that; both forms
    bit-equal at the planes on each side."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    assert tgsweep.sweep0_plan(512, 512, mode, True) == {
        "persistent": True, "rows": 4, "strips": 128}
    for has_ok in (False, True):
        for persistent in (True, False):
            side = _smem_limit(mode, has_ok, persistent)
            plan = tgsweep.sweep0_plan(side, side, mode, has_ok)
            assert plan["persistent"] == persistent, (side, has_ok, plan)
    for persistent in (True, False):
        side = _smem_limit(mode, True, persistent)
        d, cc, nc, ok = _sweep0_inputs(gen, (2, side, side), mode)
        for desc in (False, True):
            got = tgsweep.sweep0(d, cc, nc, ok, ANIS, mode, True, desc)
            want = tgsweep._sweep0_plain(d, cc, nc, ok, ANIS, mode, True,
                                         desc)
            _assert_bit_equal((got,), (want,))


def _dual_inputs(gen, shape, kind):
    cc = torch.randint(0, 4, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    if kind == "ball_rail":
        da = torch.where(_rand(gen, shape) < 0.2, -_rand(gen, shape) * 60,
                         float("inf"))
        db = torch.where(_rand(gen, shape) < 0.2, _rand(gen, shape),
                         float("inf"))
        return (da, db, cc, _rand(gen, shape) * 3,
                (_rand(gen, shape) < 0.8).to(torch.uint8))
    da = torch.where(cc > 0, _rand(gen, shape), float("-inf"))
    db = torch.where(cc > 0, _rand(gen, shape) * 7, float("-inf"))
    return da, db, cc, None, None


# B2's strips: n = 1 and 2, H = 1, H = 5, a last strip shorter than the
# others (H = 301 on 132 SMs), W = 1, W = 33 (rows off the 16-byte grid),
# a rotated non-cubic layout, and a plane on each side of the
# shared-memory rule (persistent up to about 640 x 640 on an H100)
@pytest.mark.parametrize("shape", (
    (11, 9, 8), SHAPE, (1, 7, 16), (2, 9, 16), (5, 1, 48), (6, 5, 32),
    (6, 301, 48), (7, 12, 1), (5, 20, 33), (24, 512, 128), (3, 640, 640),
    (3, 704, 704)))
@pytest.mark.parametrize("kind", ("ball_rail", "max2"))
def test_sweep0_dual_kernel_matches_plain(gen, kind, shape):
    da, db, cc, nc, ok = _dual_inputs(gen, shape, kind)
    for desc in (False, True):
        before = kernels.LAUNCHES["gsweep_sweep0_dual"]
        got = tgsweep.sweep0_dual(da, db, cc, nc, ok, ANIS, kind, desc)
        assert kernels.LAUNCHES["gsweep_sweep0_dual"] == before + 1
        again = tgsweep.sweep0_dual(da, db, cc, nc, ok, ANIS, kind, desc)
        want = tgsweep._sweep0_dual_plain(da, db, cc, nc, ok, ANIS, kind,
                                          desc)
        _assert_bit_equal(got, want)
        _assert_bit_equal(again, got)  # the mailboxes start from zero


def test_sweep0_dual_plan_follows_the_shape_rule(gen):
    """One persistent launch per sweep where a strip fits in shared
    memory, the per-plane form above that."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    small = tgsweep.dual_plan(512, 512, "ball_rail")
    assert small == {"persistent": True, "rows": 4, "strips": 128}
    assert tgsweep.dual_plan(640, 640, "max2")["persistent"]
    assert not tgsweep.dual_plan(704, 704, "ball_rail")["persistent"]
    assert not tgsweep.dual_plan(704, 704, "max2")["persistent"]


def _argmax_inputs(gen, shape, crop, n_lanes):
    cc = torch.randint(0, 5, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    field = torch.round(_rand(gen, shape) * 3)
    field = torch.where(_rand(gen, shape) < 0.2, -0.0, field)
    field = torch.where(cc == 4, float("-inf"), field).contiguous()
    hi = torch.tensor([s - c for s, c in zip(shape, crop)], device="cuda")
    offs = (_rand(gen, (n_lanes, 3)) * (hi + 1)).floor().to(torch.int32)
    lids = torch.tensor([1, 2, 3, 0, 4, 9], dtype=torch.int32, device="cuda")
    lids = lids.repeat(n_lanes // 6 + 1)[:n_lanes].contiguous()
    return field, cc, offs.contiguous(), lids


@pytest.mark.parametrize("boxed", (False, True))
def test_crop_argmax_kernel_matches_plain(gen, boxed):
    """B3 over whole windows and over random boxes inside them (every
    fifth one empty): ties, -0.0, a label of only -inf, an absent id; two
    runs agree (the order of the atomics does not show)."""
    shape, crop = (40, 36, 30), (16, 12, 10)
    field, cc, offs, lids = _argmax_inputs(gen, shape, crop, 64)
    boxes = None
    if boxed:
        crop_t = torch.tensor(crop, device="cuda")
        size = (_rand(gen, (64, 3)) * (crop_t + 1)).floor().clamp(max=crop_t)
        size[::5] = 0
        rel = (_rand(gen, (64, 3)) * (crop_t - size + 1)).floor()
        rel = rel.clamp(max=crop_t - size)
        boxes = ((offs + rel.to(torch.int32)).contiguous(),
                 size.to(torch.int32).contiguous())
    before = kernels.LAUNCHES["crop_argmax"]
    got = tcrop.crop_argmax(field, cc, offs, lids, crop, boxes)
    assert kernels.LAUNCHES["crop_argmax"] == before + 1
    again = tcrop.crop_argmax(field, cc, offs, lids, crop, boxes)
    want = tcrop._crop_argmax_plain(field, cc, offs, lids, crop, boxes)
    _assert_bit_equal(got, want)
    _assert_bit_equal(again, got)
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_crop_argmax_kernel_per_lane_crops(gen):
    """Lanes of three crop tiers in one call equal one call per tier."""
    shape = (40, 36, 30)
    tiers = ((8, 8, 8), (16, 12, 10), (32, 16, 16))
    parts = [_argmax_inputs(gen, shape, c, 12) for c in tiers]
    field, cc = parts[0][0], parts[0][1]
    offs = torch.cat([p[2] for p in parts])
    lids = torch.cat([p[3] for p in parts])
    crops = torch.tensor(tiers, dtype=torch.int32,
                         device="cuda").repeat_interleave(12, dim=0)
    got = tcrop.crop_argmax(field, cc, offs, lids, crops)
    want_c, want_v = zip(*[tcrop.crop_argmax(field, cc, p[2], p[3], c)
                           for p, c in zip(parts, tiers)])
    _assert_bit_equal(got, (torch.cat(want_c), torch.cat(want_v)))


# B5's forms by shape on a 132-SM card with 227 KB a block: one cluster of
# up to 16 CTAs while each relaxes its strip in one pass of 512 threads
# (square planes up to 170 x 170), grid-wide strips up to 1184 x 1184 in
# euclid mode (1024 x 1024 in node mode), per plane above
B5_FORMS = {False: ((170, "cluster"), (171, "strips"), (1184, "strips"),
                    (1200, "plane")),
            True: ((170, "cluster"), (171, "strips"), (1024, "strips"),
                   (1040, "plane"))}
B5_SHAPES = ((11, 9, 8), SHAPE, (1, 7, 16), (2, 9, 16), (5, 1, 48),
             (7, 12, 1), (5, 20, 33), (17, 40, 24), (96, 96, 96),
             (5, 301, 48))


def _axis0_inputs(gen, shape, clamp):
    d = torch.where(_rand(gen, shape) < 0.25,
                    _rand(gen, shape) * 10 - (5.0 if clamp else 0.0),
                    float("inf"))
    # finite positive values on both end planes: plane 0 of a sweep passes
    # through unclamped and unmasked
    d[0] = _rand(gen, shape[1:]) + 0.5
    d[-1] = _rand(gen, shape[1:]) + 0.5
    return d, _rand(gen, shape) < 0.8, _rand(gen, shape) * 3


def _check_axis0(gen, shape, node_mode):
    for clamp in (False, True):
        d, ok, nc = _axis0_inputs(gen, shape, clamp)
        for desc in (False, True):
            before = kernels.LAUNCHES["sweep_axis0"]
            got = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp, desc)
            assert kernels.LAUNCHES["sweep_axis0"] == before + 1
            again = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp,
                                       desc)
            want = tsweep._sweep_axis0_plain(d, ok, nc, ANIS, node_mode,
                                             clamp, desc)
            _assert_bit_equal((got,), (want,))
            _assert_bit_equal((again,), (got,))
            first = -1 if desc else 0
            assert torch.equal(got[first], d[first])


@pytest.mark.parametrize("shape", B5_SHAPES)
@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_kernel_matches_plain(gen, node_mode, shape):
    _check_axis0(gen, shape, node_mode)


@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_plan_follows_the_shape_rule(gen, node_mode):
    """B5's three forms, each on the planes on each side of its rule,
    bit-equal to the plain version."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    assert tsweep.sweep_axis0_plan(96, 96, node_mode) == {
        "form": "cluster", "rows": 6, "ctas": 16}
    assert tsweep.sweep_axis0_plan(1, 5, node_mode)["form"] == "cluster"
    assert tsweep.sweep_axis0_plan(1, 512, node_mode)["form"] == "cluster"
    assert tsweep.sweep_axis0_plan(1, 513, node_mode)["form"] == "strips"
    for side, form in B5_FORMS[node_mode]:
        plan = tsweep.sweep_axis0_plan(side, side, node_mode)
        assert plan["form"] == form, (side, plan)
        _check_axis0(gen, (2, side, side), node_mode)


@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_batched_kernel_matches_plain(gen, node_mode):
    shape = (5,) + SHAPE
    d = torch.where(_rand(gen, shape) < 0.25, _rand(gen, shape) * 10 - 5,
                    float("inf"))
    ok = _rand(gen, shape) < 0.8
    nc = _rand(gen, shape) * 3
    vg = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                       device="cuda", dtype=torch.int32)
    bits9 = (25, 21, 19, 23, 1, 19, 24, 20, 18)
    for clamp in (False, True):
        for desc in (False, True):
            for g, b in ((None, None), (vg, bits9)):
                # the graph-gated form counts its launches apart
                name = "sweep_axis0_batched" + ("" if g is None else "_vg")
                before = kernels.LAUNCHES[name]
                got = tsweep.sweep_axis0_batched(d, ok, nc, ANIS, node_mode,
                                                 clamp, desc, vg=g, bits9=b)
                assert kernels.LAUNCHES[name] == before + 1
                want = tsweep._sweep_axis0_batched_plain(
                    d, ok, nc, ANIS, node_mode, clamp, desc, g, b)
                _assert_bit_equal((got,), (want,))


# B1-vg (minid on G1's CCL gate, the CCL under a voxel graph): the shapes
# of B1_SHAPES, and the square planes on each side of its shape rule on a
# 132-SM card with 227 KB a block (the ids alone carried, ids and gate a
# stage: persistent up to 1056 x 1056)
B1_VG_SIDES = ((1056, True), (1072, False))


def _sweep0_vg_inputs(gen, shape):
    d, _, _, _ = _sweep0_inputs(gen, shape, "minid")
    # random move bits and occupancy (bit 26)
    gate = torch.randint(0, 1 << 27, shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    return d, gate


def _check_sweep0_vg(gen, shape):
    d, gate = _sweep0_vg_inputs(gen, shape)
    for layout in (0, 1, 2):
        for desc in (False, True):
            bits = tgsweep.gate_bits9(layout, desc)
            before = dict(kernels.LAUNCHES)
            got = tgsweep.sweep0(d, None, None, None, ANIS, "minid", False,
                                 desc, gate, bits)
            assert kernels.LAUNCHES["gsweep_sweep0_vg"] == \
                before["gsweep_sweep0_vg"] + 1
            assert kernels.LAUNCHES["gsweep_sweep0"] == \
                before["gsweep_sweep0"]
            again = tgsweep.sweep0(d, None, None, None, ANIS, "minid", False,
                                   desc, gate, bits)
            want = tgsweep._sweep0_gate_plain(d, gate, bits, desc)
            _assert_bit_equal((got, again), (want, want))
    # an all-open gate of an occupied volume is the ungated sweep of one
    # label
    full = torch.full_like(gate, (1 << 27) - 1)
    got = tgsweep.sweep0(d, None, None, None, ANIS, "minid", False, False,
                         full, tgsweep.gate_bits9(0, False))
    want = tgsweep.sweep0(d, torch.ones_like(d), None, None, ANIS, "minid",
                          False, False)
    _assert_bit_equal((got,), (want,))


@pytest.mark.parametrize("shape", B1_SHAPES)
def test_sweep0_vg_kernel_matches_plain(gen, shape):
    _check_sweep0_vg(gen, shape)


def test_sweep0_vg_plan_follows_the_shape_rule(gen):
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    assert tgsweep.sweep0_plan(512, 512, "minid", False, True) == {
        "persistent": True, "rows": 4, "strips": 128}
    for side, persistent in B1_VG_SIDES:
        plan = tgsweep.sweep0_plan(side, side, "minid", False, True)
        assert plan["persistent"] == persistent, (side, plan)
        _check_sweep0_vg(gen, (2, side, side))
    with pytest.raises(ValueError):
        tgsweep.sweep0_plan(64, 64, "euclid", False, True)


# B5 with a graph gate: its forms on each side of their rules (the gate is
# one more word of a voxel's stage, the carried plane holds the field
# only: grid strips up to 1024 x 1024 in euclid mode and 912 x 912 in node
# mode)
B5_VG_FORMS = {False: ((170, "cluster"), (171, "strips"), (1024, "strips"),
                       (1040, "plane")),
               True: ((170, "cluster"), (171, "strips"), (912, "strips"),
                      (928, "plane"))}


def _check_axis0_vg(gen, shape, node_mode):
    """The gated kernel in both forms of the graph: source bitfields (the
    wrapper builds their gate) against the plain source form, and a gate
    against the plain gate form."""
    vg = torch.randint(0, 1 << 26, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    for clamp in (False, True):
        d, ok, nc = _axis0_inputs(gen, shape, clamp)
        for axis in (0, 2):
            for desc in (False, True):
                bits = tgeodesic.sweep_bits9(axis, desc)
                before = dict(kernels.LAUNCHES)
                got = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp,
                                         desc, vg=vg, bits9=bits)
                assert kernels.LAUNCHES["sweep_axis0_vg"] == \
                    before["sweep_axis0_vg"] + 1
                assert kernels.LAUNCHES["sweep_axis0"] == \
                    before["sweep_axis0"]
                again = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp,
                                           desc, vg=vg.view(torch.uint32),
                                           bits9=bits)
                want = tsweep._sweep_axis0_plain(d, ok, nc, ANIS, node_mode,
                                                 clamp, desc, vg, bits)
                _assert_bit_equal((got, again), (want, want))
                first = -1 if desc else 0
                assert torch.equal(got[first], d[first])
                gbits = tgsweep.gate_bits9(axis, desc)
                got = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp,
                                         desc, gate=vg, gate_bits9=gbits)
                want = tsweep._sweep_axis0_plain(d, ok, nc, ANIS, node_mode,
                                                 clamp, desc, gate=vg,
                                                 gate_bits9=gbits)
                _assert_bit_equal((got,), (want,))


@pytest.mark.parametrize("shape", B5_SHAPES)
@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_vg_kernel_matches_plain(gen, node_mode, shape):
    _check_axis0_vg(gen, shape, node_mode)


@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_vg_plan_follows_the_shape_rule(gen, node_mode):
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    for side, form in B5_VG_FORMS[node_mode]:
        plan = tsweep.sweep_axis0_plan(side, side, node_mode, True)
        assert plan["form"] == form, (side, plan)
        _check_axis0_vg(gen, (2, side, side), node_mode)


def test_skeletonize_self_touch_cuda_matches_cpu(gen):
    """skeletonize under a voxel graph (two touching blobs merged, walled
    apart by their former labels' graph; one label given 17 manual
    targets, which the host trace path takes) on the card equals the CPU,
    and the graph-gated kernels ran."""
    rng = np.random.RandomState(2)
    pre = np.zeros((40, 36, 30), dtype=np.uint32)
    x, y, z = np.ogrid[:40, :36, :30]
    for lab in range(1, 7):
        c = rng.randint(4, np.array(pre.shape) - 4)
        r = rng.randint(3, 7, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        pre[((e + rng.rand(*pre.shape) * 0.4) < 1.0) & (pre == 0)] = lab
    vg = np.zeros(pre.shape, dtype=np.uint32)
    for o, bit in GRAPH_BITS.items():
        dst = tuple(slice(max(-c, 0), n + min(-c, 0))
                    for c, n in zip(o, pre.shape))
        src = tuple(slice(max(c, 0), n + min(c, 0))
                    for c, n in zip(o, pre.shape))
        vg[dst] |= (pre[dst] == pre[src]).astype(np.uint32) << np.uint32(bit)
    merged = np.where(pre == 2, 1, pre)
    big = np.bincount(pre.ravel())[1:].argmax() + 1
    pts = [tuple(int(c) for c in p)
           for p in np.argwhere(pre == big)[::11][:17]]
    kw = dict(teasar_params={"scale": 1.5, "const": 30, "pdrf_exponent": 4,
                             "pdrf_scale": 100000},
              anisotropy=(16, 16, 40), dust_threshold=10, voxel_graph=vg,
              extra_targets_before=pts)
    before = dict(kernels.LAUNCHES)
    a = kimimaro_tpu_torch.skeletonize(merged, device="cuda", **kw)
    for k in ("gsweep_sweep0_vg", "sweep_axis0_batched_vg", "sweep_axis0_vg",
              "graph_into", "graph_into_ccl"):
        assert kernels.LAUNCHES[k] > before[k], k
    # the global engine takes no label under a graph (the ungated B1
    # still runs the border faces' CCL)
    for k in ("gsweep_sweep0_dual", "crop_argmax"):
        assert kernels.LAUNCHES[k] == before[k], k
    b = kimimaro_tpu_torch.skeletonize(merged, device="cpu", **kw)
    assert set(a) == set(b) and len(a) >= 3
    for k in a:
        assert a[k].to_swc() == b[k].to_swc(), k


def test_crop_engine_cuda_matches_cpu(gen):
    """engine.trace_batched on the card equals the same call on the CPU:
    an L-tube, a bent tube and a ball in soma mode, in two buckets."""
    from kimimaro_tpu_torch import engine
    from kimimaro_tpu_torch.ops import edt

    vol = np.zeros((40, 40, 16), dtype=np.int32)
    vol[4:36, 18:22, 2:6] = 1
    vol[18:22, 4:36, 2:6] = 1
    for x in range(4, 36):
        y = 30 + int(round(3 * np.sin(x / 4.0)))
        vol[x, y:y + 2, 9:12] = 2
    g = np.indices(vol.shape).transpose(1, 2, 3, 0)
    vol[np.sum((g - (9, 9, 10)) ** 2, axis=-1) <= 30] = 3
    tp = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 60,
          "soma_acceptance_threshold": 70}
    jobs = []
    for segid in (1, 2, 3):
        pts = np.argwhere(vol == segid)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        jobs.append({"segid": segid, "offset": mn, "shape": mx - mn + 1,
                     "before": [], "after": [], "root": None})
    out = {}
    for device in ("cuda", "cpu"):
        cc = torch.from_numpy(vol).to(device)
        dbf = edt.edt(cc, (16.0, 16.0, 40.0))
        before = kernels.LAUNCHES["sweep_axis0_batched"]
        out[device] = engine.trace_batched(cc, dbf, jobs, tp,
                                           (16.0, 16.0, 40.0), True)
        if device == "cuda":
            assert kernels.LAUNCHES["sweep_axis0_batched"] > before
    (a, fa), (b, fb) = out["cuda"], out["cpu"]
    assert [j["segid"] for j in fa] == [j["segid"] for j in fb]
    assert set(a) == set(b) and len(a) >= 2
    for segid in a:
        for (va, ra), (vb, rb) in zip(a[segid], b[segid]):
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(ra, rb)


def test_kernel_wrappers_reject_bad_operands(gen):
    d = torch.zeros(SHAPE, device="cuda")
    cc = torch.zeros(SHAPE, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError):
        tgsweep.sweep0(d, cc, None, None, ANIS, "euclid", False, False)
    with pytest.raises(ValueError):
        tgsweep.sweep0(d.transpose(0, 1), cc.int(), None, None, ANIS,
                       "euclid", False, False)


def test_skeletonize_cuda_matches_cpu(gen):
    rng = np.random.RandomState(1)
    vol = np.zeros((40, 36, 30), dtype=np.uint32)
    x, y, z = np.ogrid[:40, :36, :30]
    for lab in range(1, 7):
        c = rng.randint(4, np.array(vol.shape) - 4)
        r = rng.randint(3, 7, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        vol[((e + rng.rand(*vol.shape) * 0.4) < 1.0) & (vol == 0)] = lab
    tp = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 1e9,
          "soma_acceptance_threshold": 1e9}
    a = kimimaro_tpu_torch.skeletonize(vol, teasar_params=tp,
                                       anisotropy=(16, 16, 40),
                                       dust_threshold=10, device="cuda")
    b = kimimaro_tpu_torch.skeletonize(vol, teasar_params=tp,
                                       anisotropy=(16, 16, 40),
                                       dust_threshold=10, device="cpu")
    assert set(a) == set(b) and len(a) >= 3
    for k in a:
        assert kimimaro_tpu_torch.Skeleton.equivalent(a[k], b[k])


def _xs_windows(seed, B, Wx, Wy, density=0.7):
    """Random section words, slab bases (slope <= 1) and seed words."""
    rng = np.random.RandomState(seed)
    secb = (rng.randint(0, 32, size=(B, Wx, Wy))
            & rng.randint(0, 32, size=(B, Wx, Wy))).astype(np.int32)
    secb[rng.rand(B, Wx, Wy) > density] = 0
    ii, jj = np.meshgrid(np.arange(Wx), np.arange(Wy), indexing="ij")
    zb = np.floor(rng.uniform(-1, 1, (B, 1, 1)) * ii
                  + rng.uniform(-1, 1, (B, 1, 1)) * jj).astype(np.int32) - 2
    seed_w = np.zeros_like(secb)
    seed_w[:, Wx // 2, Wy // 2] = 31
    return [torch.from_numpy(a).cuda() for a in (seed_w & secb, secb, zb)]


X1_DILATE_EDGES = [(w, r) for w in ((1, 1), (5, 31), (32, 32), (33, 17),
                                    (64, 64)) for r in (0, 1, 36, 96)]


@pytest.mark.parametrize("method,window,rounds", [
    ("dilate", (13, 10), 2), ("dilate", (32, 29), 36),
    ("dilate", (100, 97), 8), ("dilate", (130, 127), 4),
    ("sweep", (13, 10), 0), ("sweep", (64, 61), 6),
    ("sweep", (128, 125), 6), ("sweep", (200, 197), 3)]
    + [("dilate", w, r) for w, r in X1_DILATE_EDGES])
def test_section_flood_kernel_matches_plain(gen, method, window, rounds):
    """X1's dilation in registers (windows up to 64 x 64, one warp a lane)
    and in device memory (above), its sweep in shared memory, lanes that
    converge and lanes that run out of rounds."""
    from kimimaro_tpu_torch.ops import xsslab

    Wx, Wy = window
    seed, secb, zb = _xs_windows(Wx + Wy, 5, Wx, Wy)
    before = kernels.LAUNCHES["section_flood"]
    got = xsslab.section_flood(seed, secb, zb, rounds, method)
    assert kernels.LAUNCHES["section_flood"] == before + 1
    want = xsslab._section_flood_plain(seed, secb, zb, rounds, method)
    _assert_bit_equal(got, want)


def test_fma_f32_kernel_matches_plain(gen):
    """F1 against its plain version (float64, round-to-odd) on triples at
    float32 midpoints and on broadcast operands and constants."""
    from kimimaro_tpu_torch.ops import fma

    n = 1 << 18
    m = torch.floor(_rand(gen, (2, n)) * 4096 + 4096) * torch.exp2(
        torch.floor(_rand(gen, (2, n)) * 28) - 44)
    p = m[0].double() * m[1].double()
    c = (torch.sign(_rand(gen, (n,)) - 0.5) * p * torch.exp2(
        -torch.floor(_rand(gen, (n,)) * 30 + 30).double())).float()
    cases = [(m[0], m[1], c),
             (_rand(gen, (3, 5, 7, 2)), _rand(gen, (3, 1, 1, 1)), 1.0),
             (_rand(gen, (3, 5, 7, 2)), 10.0, _rand(gen, (1, 5, 1, 2))),
             (_rand(gen, (6,)), 1.5, 30.0)]
    for a, b, c in cases:
        before = kernels.LAUNCHES["fma_f32"]
        got = fma.fma_f32(a, b, c)
        assert kernels.LAUNCHES["fma_f32"] == before + 1
        plain = [t if isinstance(t, torch.Tensor) else torch.tensor(
            t, dtype=torch.float32, device="cuda") for t in (a, b, c)]
        _assert_bit_equal((got,), (fma._fma_f32_plain(*plain),))


# windows on each side of section_flood_plan's rule: one CTA of a warp
# per 32 columns a lane up to 256 columns while the packed window fits a
# block's shared memory, one cluster a lane above (each CTA a band of
# rows), one CTA a lane over device memory where a row outgrows the
# cluster's 16 warps x 8 columns
X1_FORMS = ((13, 10, "warps"), (128, 125, "warps"), (200, 197, "warps"),
            (33, 64, "warps"), (240, 17, "warps"),
            (250, 250, "cluster"), (256, 256, "cluster"),
            (512, 509, "cluster"), (20, 4100, "lane_cta"))


@pytest.mark.parametrize("Wx,Wy,form", X1_FORMS)
def test_section_flood_plan_follows_the_shape_rule(gen, Wx, Wy, form):
    """Each form bit-equal to the plain sweep, with zb far beyond int16 in
    the empty columns (the packed forms never read it there)."""
    from kimimaro_tpu_torch.ops import xsslab

    plan = xsslab.section_flood_plan(Wx, Wy)
    assert plan[0] == form, plan
    assert plan[2] == (form != "lane_cta")
    seed, secb, zb = _xs_windows(Wx + Wy, 3, Wx, Wy)
    zb = torch.where(secb != 0, zb, zb - (1 << 24))
    rounds = 0 if form == "lane_cta" else 2
    before = kernels.LAUNCHES["section_flood"]
    got = xsslab.section_flood(seed, secb, zb, rounds, "sweep")
    assert kernels.LAUNCHES["section_flood"] == before + 1
    want = xsslab._section_flood_plain(seed, secb, zb, rounds, "sweep")
    _assert_bit_equal(got, want)


# the dilation's windows on each side of its lane-warp rule: one warp a
# lane while one axis has at most 64 columns and the other at most 64
# cells, one CTA a lane beyond
X1_DILATE_FORMS = ((1, 1, "lane_warp"), (3, 64, "lane_warp"),
                   (64, 64, "lane_warp"), (65, 3, "lane_cta"),
                   (64, 65, "lane_cta"))


@pytest.mark.parametrize("Wx,Wy,form", X1_DILATE_FORMS)
def test_section_flood_dilate_plan_follows_the_shape_rule(gen, Wx, Wy, form):
    """Each form of the dilation bit-equal to the plain one, with zb far
    beyond int16 in the empty columns (the lane-warp form never reads it
    there)."""
    from kimimaro_tpu_torch.ops import xsslab

    plan = xsslab.section_flood_plan(Wx, Wy, "dilate")
    assert plan[0] == form, plan
    seed, secb, zb = _xs_windows(Wx * 3 + Wy, 4, Wx, Wy)
    zb = torch.where(secb != 0, zb, zb - (1 << 24))
    before = kernels.LAUNCHES["section_flood"]
    got = xsslab.section_flood(seed, secb, zb, 5, "dilate")
    assert kernels.LAUNCHES["section_flood"] == before + 1
    want = xsslab._section_flood_plain(seed, secb, zb, 5, "dilate")
    _assert_bit_equal(got, want)


def test_check_zb_rejects_zb_beyond_int16_in_a_section(gen):
    from kimimaro_tpu_torch.ops import xsslab

    seed, secb, zb = _xs_windows(3, 2, 16, 16)
    secb[0, 3, 3] = 1
    zb[0, 3, 3] = 1 << 16
    with pytest.raises(ValueError):
        xsslab.check_zb(secb, zb)


# B4's forms on each side of sweep_axis0_batched_plan's rule (132 SMs):
# one cluster a lane while a strip of at most 16 CTAs takes one pass of
# 512 threads, the most CTAs that keep B x CTAs within the SMs (but the
# fewest that take one pass at least); per-lane grid strips above; one
# launch per plane where B exceeds the co-resident CTAs
B4_FORMS = (((1, 3, 1, 1), "cluster", 1), ((5, 9, 7, 1), "cluster", 7),
            ((2, 8, 256, 128), "cluster", 16),
            ((2, 8, 272, 128), "strips", 55),
            ((64, 5, 128, 32), "cluster", 2),
            ((64, 3, 128, 128), "cluster", 8),
            ((2, 5, 256, 64), "cluster", 16),
            ((2, 3, 256, 256), "strips", 64),
            ((200, 2, 300, 300), "plane", 0))


@pytest.mark.parametrize("shape,form,ctas", B4_FORMS)
def test_sweep_axis0_batched_plan_follows_the_shape_rule(gen, shape, form,
                                                         ctas):
    """Each form bit-equal to the plain version, node and euclid, with and
    without the voxel graph, one launch a sweep."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the shapes are those of a 132-SM card")
    B, n, H, W = shape
    plan = tsweep.sweep_axis0_batched_plan(B, H, W, True)
    assert plan["form"] == form, plan
    assert plan["ctas"] == ctas, plan
    d = torch.where(_rand(gen, shape) < 0.25, _rand(gen, shape) * 10 - 5,
                    float("inf"))
    ok = _rand(gen, shape) < 0.8
    nc = _rand(gen, shape) * 3
    vg = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                       device="cuda", dtype=torch.int32)
    bits9 = (25, 21, 19, 23, 1, 19, 24, 20, 18)
    for node_mode in (False, True):
        for g, b in ((None, None), (vg, bits9)):
            # the graph-gated form counts its launches apart
            name = "sweep_axis0_batched" + ("" if g is None else "_vg")
            before = kernels.LAUNCHES[name]
            got = tsweep.sweep_axis0_batched(d, ok, nc, ANIS, node_mode,
                                             False, True, vg=g, bits9=b)
            assert kernels.LAUNCHES[name] == before + 1
            want = tsweep._sweep_axis0_batched_plain(
                d, ok, nc, ANIS, node_mode, False, True, g, b)
            _assert_bit_equal((got,), (want,))


# G1: one voxel, lanes of one row, odd widths, more than 65,535 lanes (a
# tile each), two leading lane axes, the widths on each side of its z
# tiles (32, 16 and 8 voxels: Z = 8, 9, 16, 17), and lanes of more rows
# than one tile holds
G1_SHAPES = ((1, 1, 1), (3, 1, 5, 7), (2, 9, 1, 33), (17, 40, 24),
             (70000, 1, 2, 3), (2, 3, 5, 4, 6), (4, 64, 64, 32),
             (3, 5, 70, 8), (2, 7, 37, 9), (2, 4, 33, 16), (1, 6, 20, 17),
             (1, 300, 11, 65), (1, 3, 300, 5), (2, 2, 45, 40))


def _g1_inputs(gen, shape):
    """Random words (every bit) and labels of three values and 0, two of
    them negative words."""
    vg = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                       device="cuda", dtype=torch.int32)
    lab = torch.randint(0, 4, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    return vg, torch.where(lab == 3, -5, torch.where(lab == 2, -1, lab))


@pytest.mark.parametrize("shape", G1_SHAPES)
def test_graph_into_kernel_matches_plain(gen, shape):
    vg, _ = _g1_inputs(gen, shape)
    before = kernels.LAUNCHES["graph_into"]
    got = tstencils.graph_into(vg.view(torch.uint32))
    assert kernels.LAUNCHES["graph_into"] == before + 1
    want = tstencils._graph_into_plain(vg)
    _assert_bit_equal((got, tstencils.graph_into(vg)), (want, want))
    # a lane's gate is its own graph's
    if len(shape) == 4:
        _assert_bit_equal((got[-1],), (tstencils.graph_into(vg[-1]),))


@pytest.mark.parametrize("shape", G1_SHAPES)
def test_graph_into_ccl_kernel_matches_plain(gen, shape):
    vg, lab = _g1_inputs(gen, shape)
    before = dict(kernels.LAUNCHES)
    got = tstencils.graph_into(vg.view(torch.uint32), lab)
    assert kernels.LAUNCHES["graph_into_ccl"] == before["graph_into_ccl"] + 1
    assert kernels.LAUNCHES["graph_into"] == before["graph_into"]
    want = tstencils._graph_into_plain(vg, lab)
    _assert_bit_equal((got, tstencils.graph_into(vg, lab)), (want, want))
    if len(shape) == 4:
        _assert_bit_equal((got[-1],), (tstencils.graph_into(vg[-1],
                                                            lab[-1]),))


# B4 with a graph gate on each side of its plan rule: two lanes of planes
# too wide for a cluster, per-lane grid strips (66 CTAs a lane) up to
# 720 x 720 in euclid mode and 640 x 640 in node mode, per plane beyond
B4_VG_FORMS = ((False, (2, 2, 720, 720), "strips"),
               (False, (2, 2, 736, 736), "plane"),
               (True, (2, 2, 640, 640), "strips"),
               (True, (2, 2, 656, 656), "plane"))


@pytest.mark.parametrize("node_mode,shape,form", B4_VG_FORMS)
def test_sweep_axis0_batched_vg_plan_follows_the_shape_rule(gen, node_mode,
                                                            shape, form):
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the shapes are those of a 132-SM card")
    B, n, H, W = shape
    plan = tsweep.sweep_axis0_batched_plan(B, H, W, node_mode, True)
    assert plan["form"] == form, plan
    d = torch.where(_rand(gen, shape) < 0.25, _rand(gen, shape) * 10 - 5,
                    float("inf"))
    ok = _rand(gen, shape) < 0.8
    nc = _rand(gen, shape) * 3
    gate = torch.randint(0, 1 << 26, shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    for desc in (False, True):
        bits = tgsweep.gate_bits9(1, desc)
        before = kernels.LAUNCHES["sweep_axis0_batched_vg"]
        got = tsweep.sweep_axis0_batched(d, ok, nc, ANIS, node_mode, True,
                                         desc, gate=gate, gate_bits9=bits)
        assert kernels.LAUNCHES["sweep_axis0_batched_vg"] == before + 1
        want = tsweep._sweep_axis0_batched_plain(
            d, ok, nc, ANIS, node_mode, True, desc, gate=gate,
            gate_bits9=bits)
        _assert_bit_equal((got,), (want,))


def test_fetch_secb_kernel_matches_plain(gen):
    """B6 on windows at the volume faces and inside, with cells whose z
    falls outside the volume."""
    from kimimaro_tpu_torch.ops import xsfetch

    rng = np.random.RandomState(0)
    tx, ty, tz = 37, 29, 23
    vol = torch.from_numpy(
        rng.randint(0, 4, size=(tx, ty, tz)).astype(np.int32)).cuda()
    B, Wx, Wy = 6, 13, 17
    wx0 = torch.tensor([0, tx - Wx, 5, 11, 0, 24], dtype=torch.int32,
                       device="cuda")
    wy0 = torch.tensor([0, ty - Wy, 3, 0, 12, 7], dtype=torch.int32,
                       device="cuda")
    labels = torch.tensor([1, 2, 3, 1, 0, 9], dtype=torch.int32,
                          device="cuda")
    zb = torch.from_numpy(rng.randint(-6, tz + 2, size=(B, Wx, Wy))
                          .astype(np.int32)).cuda()
    before = kernels.LAUNCHES["fetch_secb"]
    got = xsfetch.fetch_secb(vol, zb, wx0, wy0, labels)
    assert kernels.LAUNCHES["fetch_secb"] == before + 1
    want = xsfetch._fetch_secb_plain(vol, zb, wx0, wy0, labels)
    _assert_bit_equal((got,), (want,))
    assert bool(got.any())


# (tz, W, lanes, volume base offset in int32): the vector path (tz % 4
# == 0, aligned base) and the scalar path (tz % 4 != 0, or a volume view 4
# bytes past an aligned base), windows of Wx * Wy % 4 != 0 (4-byte zb and
# word accesses), W up to 512, and more lanes than a grid's y extent
B6_CASES = ((64, 32, 9, 0), (66, 64, 7, 0), (128, 128, 5, 0),
            (23, 13, 6, 0), (512, 17, 4, 0), (36, 512, 2, 0),
            (37, 512, 2, 0), (64, 64, 5, 1), (16, 3, 70000, 0))


@pytest.mark.parametrize("tz,W,B,shift", B6_CASES)
def test_fetch_secb_paths_match_plain(gen, tz, W, B, shift):
    """B6's vector and scalar paths against the plain version: window
    starts anywhere (the volume's faces, odd offsets), zb below 0 and
    beyond tz, labels absent from the volume."""
    from kimimaro_tpu_torch.ops import xsfetch

    tx, ty = max(W + 9, 24), max(W + 5, 20)
    Wx, Wy = W, W - 1 if W > 3 else W
    raw = torch.randint(0, 4, (tx * ty * tz + shift,), generator=gen,
                        device="cuda", dtype=torch.int32)
    vol = raw[shift:].view(tx, ty, tz)
    wx0 = torch.randint(0, tx - Wx + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    wy0 = torch.randint(0, ty - Wy + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    wx0[0], wy0[0] = 0, ty - Wy
    labels = torch.randint(0, 4, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[-1] = 9  # absent from the volume
    zb = torch.randint(-7, tz + 3, (B, Wx, Wy), generator=gen,
                       device="cuda", dtype=torch.int32)
    plan = xsfetch.fetch_plan(vol, zb)
    assert plan["vector"] == (tz % 4 == 0 and shift == 0)
    before = kernels.LAUNCHES["fetch_secb"]
    got = xsfetch.fetch_secb(vol, zb, wx0, wy0, labels)
    assert kernels.LAUNCHES["fetch_secb"] == before + 1
    want = xsfetch._fetch_secb_plain(vol, zb, wx0, wy0, labels)
    _assert_bit_equal((got,), (want,))
    assert bool(got.any())


def _fma_cases(gen):
    """(operands, route): n % 4 != 0, a view 4 bytes past an aligned
    base, one-element tensors and constants (flat); the cross sections'
    broadcasts of xsbatch `_finish_section` (t = zidx * denom + a) and
    `slab_sections_volume` (the window plane), and a transposed operand
    (strided)."""
    n = (1 << 20) + 3
    buf = _rand(gen, (n + 8,)) * 200 - 100
    B, Wx, Wy, K = 37, 64, 63, 5
    return (
        ((buf[:n], buf[4:n + 4], buf[2:n + 2]), "flat"),
        ((buf[1:n + 1], _rand(gen, (n,)), 1.0), "flat"),
        ((buf[:n], torch.tensor(0.37, device="cuda"), 30.0), "flat"),
        ((buf[:4099], 10.0, 10.0), "flat"),
        (((torch.randint(-40, 40, (B, Wx, Wy, K), generator=gen,
                         device="cuda")).float(),
          _rand(gen, (B, 1, 1, 1)) * 40, _rand(gen, (B, Wx, Wy, 1)) * 900),
         "strided"),
        ((_rand(gen, (B, 1, Wy)) * 900, _rand(gen, (B, 1, 1)),
          _rand(gen, (B, Wx, Wy)) * 900), "strided"),
        ((_rand(gen, (33, 65, 7)).transpose(0, 2), 1.5,
          _rand(gen, (7, 65, 1))), "strided"),
    )


@pytest.mark.parametrize("negate", (False, True))
def test_fma_f32_routes_match_plain(gen, negate):
    """F1's flat and strided routes, with and without `negate`, each
    bit-equal to the plain version (float64, round-to-odd)."""
    from kimimaro_tpu_torch.ops import fma

    for operands, route in _fma_cases(gen):
        ts = [x for x in operands if isinstance(x, torch.Tensor)]
        shape = torch.broadcast_shapes(*(x.shape for x in ts))
        views = [x.broadcast_to(shape) if isinstance(x, torch.Tensor)
                 else None for x in operands]
        assert fma.fma_plan(shape, views)["route"] == route
        before = kernels.LAUNCHES["fma_f32"]
        got = fma.fma_f32(*operands, negate=negate)
        assert kernels.LAUNCHES["fma_f32"] == before + 1
        plain = [t if isinstance(t, torch.Tensor) else torch.tensor(
            t, dtype=torch.float32, device="cuda") for t in operands]
        _assert_bit_equal((got,), (fma._fma_f32_plain(*plain,
                                                       negate=negate),))


def test_cross_sectional_area_cuda_matches_cpu(gen):
    """Cross sections on the card equal the same calls on the CPU: the
    batched path, and the per-label path (fill_holes) with its dense rung
    on two zero normals."""
    from kimimaro_tpu_torch.ops import xsarea

    labels = np.zeros((48, 40, 36), dtype=np.uint32)
    labels[4:44, 6:10, 6:10] = 7
    labels[10:14, 4:36, 20:24] = 900
    labels[30:34, 28:32, 2:34] = 31
    labels[38:46, 20:28, 22:30] = 4242
    skels = kimimaro_tpu_torch.skeletonize(
        labels, teasar_params={"scale": 1.5, "const": 2}, dust_threshold=10,
        anisotropy=(16, 16, 40), fix_borders=False, device="cpu")
    for kw in ({}, {"fill_holes": True}):
        out = {}
        for device in ("cuda", "cpu"):
            before = dict(kernels.LAUNCHES)
            out[device] = kimimaro_tpu_torch.cross_sectional_area(
                labels, {k: s.clone() for k, s in skels.items()},
                anisotropy=(16, 16, 40), device=device, **kw)
            if device == "cuda":
                for k in ("fetch_secb", "section_flood"):
                    assert kernels.LAUNCHES[k] > before[k]
        for k in skels:
            a, b = out["cuda"][k], out["cpu"][k]
            np.testing.assert_allclose(a.cross_sectional_area,
                                       b.cross_sectional_area, rtol=1e-5,
                                       atol=0)
            np.testing.assert_array_equal(a.cross_sectional_area_contacts,
                                          b.cross_sectional_area_contacts)
    binimg = labels == 4242
    verts = np.argwhere(binimg)[::40]
    normals = np.tile(np.float32([[0.0, 0.6, 0.8]]), (len(verts), 1))
    normals[:2] = 0.0
    before = kernels.LAUNCHES["sweep_axis0_batched"]
    a = xsarea.cross_section_areas(binimg, verts, normals, (16, 16, 40),
                                   device="cuda")
    assert kernels.LAUNCHES["sweep_axis0_batched"] > before
    b = xsarea.cross_section_areas(binimg, verts, normals, (16, 16, 40))
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(a[1], b[1])


def test_fill_label_crops_cuda_matches_cpu(gen):
    """The batched hole masks at every crop tier up to 128: a label whose
    bbox spans 128 along x takes the 128 tier."""
    import scipy.ndimage

    from kimimaro_tpu_torch.ops import fill as tfill

    vol = np.zeros((140, 62, 62), dtype=np.int32)
    spans = ((4, 1), (12, 7), (28, 21), (60, 51), (128, 9))
    lid = 1
    for ext, x0 in spans[:4]:
        sl = (slice(x0, x0 + ext), slice(1, 1 + min(ext, 60)),
              slice(1, 1 + min(ext, 60)))
        vol[sl] = lid
        vol[tuple(slice(q.start + 1, q.stop - 1) for q in sl)] = 0
        lid += 1
    # the 128 tier: a long hollow bar
    vol[9:137, 40:50, 40:50] = lid
    vol[11:135, 42:48, 42:48] = 0
    vol[60:62, 44:46, 44:46] = lid + 1  # a pit in its hole
    slcs = scipy.ndimage.find_objects(vol)
    lids = [i + 1 for i, s in enumerate(slcs) if s is not None]
    offs = np.array([[x.start for x in slcs[i - 1]] for i in lids])
    shapes = np.array([[x.stop - x.start for x in slcs[i - 1]]
                       for i in lids])
    assert shapes.max() == 128
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = tfill.fill_label_crops(
            torch.from_numpy(vol).to(device), offs, shapes, np.array(lids),
            vol.shape)
    assert sum(n for _, n in out["cpu"]) > 0
    for (gh, gn), (wh, wn) in zip(out["cuda"], out["cpu"]):
        assert gn == wn
        if wn:
            np.testing.assert_array_equal(gh, wh)
        else:
            assert gh is None


def test_skeletonize_host_stages_cuda_matches_cpu(gen):
    """skeletonize(fill_holes=True, fix_avocados=True): a hollow ball
    clipped by the volume's face with a pit on that face, among blobs;
    every label takes the crop engine (B4)."""
    rng = np.random.RandomState(1)
    vol = np.zeros((40, 36, 30), dtype=np.uint32)
    x, y, z = np.ogrid[:40, :36, :30]
    for lab in range(1, 7):
        c = rng.randint(4, np.array(vol.shape) - 4)
        r = rng.randint(3, 7, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        vol[((e + rng.rand(*vol.shape) * 0.4) < 1.0) & (vol == 0)] = lab
    vol[((x - 3) ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2) <= 100] = 8
    vol[((x - 6) ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2) <= 6] = 0
    vol[(x ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2) <= 12] = 9
    tp = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 60,
          "soma_acceptance_threshold": 3500}
    out = {}
    for device in ("cuda", "cpu"):
        before = kernels.LAUNCHES["sweep_axis0_batched"]
        out[device] = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=tp, anisotropy=(16, 16, 40),
            dust_threshold=10, fill_holes=True, fix_avocados=True,
            device=device)
        if device == "cuda":
            assert kernels.LAUNCHES["sweep_axis0_batched"] > before
    assert set(out["cuda"]) == set(out["cpu"]) and 9 not in out["cpu"]
    for k in out["cpu"]:
        assert kimimaro_tpu_torch.Skeleton.equivalent(out["cuda"][k],
                                                      out["cpu"][k]), k


@pytest.mark.parametrize("dtype", (np.uint32, np.uint64, np.int16))
def test_streamed_upload_cuda_matches_plain(gen, dtype):
    """A CompressedLabelVolume streamed into the card (partial last slab,
    pinned buffers in turn) equals the plain upload of the array."""
    from kimimaro_tpu_torch import intake

    rng = np.random.RandomState(2)
    labels = rng.randint(0, 6, size=(33, 17, 45)).astype(dtype)
    if dtype == np.uint64:
        labels *= np.uint64(2**40)
    elif dtype == np.int16:
        labels -= 2
    cv = kimimaro_tpu_torch.CompressedLabelVolume(labels, slab=8)
    _, _, wide_back, up = intake._plan_streaming(cv, None)
    got = up(torch.device("cuda"))
    host = labels
    if wide_back is not None:
        u = np.unique(labels)
        u = u[u != 0]
        host = (np.searchsorted(u, labels).astype(np.uint32) + 1) * (
            labels != 0)
    want = intake._upload(host, torch.device("cuda"))
    assert got.dtype == torch.int32 and torch.equal(got, want)


# V1: the joint Voronoi sweep. Its forms: one cluster up to 170 x 170,
# grid-wide strips up to about 850 x 850 (two carried fields), per plane
# beyond
V1_FORMS = ((170, "cluster"), (171, "strips"), (840, "strips"),
            (880, "plane"))
# V1 at its edges: a sweep of one and two planes, 7 and 9 planes, planes
# of one, three and 17 rows, a cluster whose last strip is short, a plane
# that several strips share, a 512 x 512 plane in grid-wide strips
V1_EDGES = tuple((n, H, 6) for n in (1, 2, 7, 9) for H in (1, 3, 17)) \
    + ((17, 130, 121), (33, 301, 48), (18, 512, 512))


def _voronoi_inputs(gen, shape, ties):
    """A distance field with a quarter finite (small integers where `ties`,
    so that isotropic costs tie), features of those voxels, an ok mask;
    non-ok voxels +inf, as the relaxation keeps them."""
    ok = _rand(gen, shape) < 0.85
    seeded = _rand(gen, shape) < 0.25
    vals = (torch.floor(_rand(gen, shape) * 4) if ties
            else _rand(gen, shape) * 10)
    d = torch.where(seeded & ok, vals, float("inf"))
    f = torch.where(seeded, torch.randint(1, 1 << 30, shape, generator=gen,
                                          device="cuda", dtype=torch.int32),
                    0).to(torch.int32)
    return d.contiguous(), f.contiguous(), ok.contiguous()


def _check_voronoi(gen, shape, anis, ties=False):
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    d, f, ok = _voronoi_inputs(gen, shape, ties)
    for desc in (False, True):
        costs = tgeodesic.plane_costs(0, desc, anis)
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        want_flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        before = kernels.LAUNCHES["voronoi_sweep"]
        got = tvoronoi.voronoi_sweep(d, f, ok, costs, desc, flag)
        assert kernels.LAUNCHES["voronoi_sweep"] == before + 1
        again = tvoronoi.voronoi_sweep(d, f, ok, costs, desc,
                                       torch.zeros_like(flag))
        want = tvoronoi._voronoi_sweep_plain(d, f, ok, costs, desc, want_flag)
        _assert_bit_equal(got, want)
        _assert_bit_equal(again, got)
        assert int(flag) == int(want_flag)
        # the sweep's output is its own fixpoint: a second sweep in the same
        # direction changes nothing and leaves the flag 0
        still = torch.zeros_like(flag)
        _assert_bit_equal(
            tvoronoi.voronoi_sweep(got[0], got[1], ok, costs, desc, still), got)
        assert int(still) == 0
        # its distance is B5's euclid sweep of the same field
        b5 = tsweep.sweep_axis0(d, ok, None, anis, False, False, desc)
        _assert_bit_equal((got[0],), (b5,))
        # the first plane passes through
        first = -1 if desc else 0
        assert torch.equal(got[0][first], d[first])


@pytest.mark.parametrize("shape", B5_SHAPES + V1_EDGES)
@pytest.mark.parametrize("ties", (False, True))
def test_voronoi_sweep_kernel_matches_plain(gen, shape, ties):
    _check_voronoi(gen, shape, (1.0, 1.0, 1.0) if ties else ANIS, ties)


def test_voronoi_plan_follows_the_shape_rule(gen):
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    for side, form in V1_FORMS:
        plan = tvoronoi.voronoi_plan(side, side)
        assert plan["form"] == form, (side, plan)
        _check_voronoi(gen, (2, side, side), ANIS, ties=True)


def test_voronoi_feature_field_cuda_matches_cpu(gen):
    rng = np.random.RandomState(3)
    ok = rng.rand(40, 33, 21) < 0.8
    seeds = np.argwhere(ok)[rng.choice(int(ok.sum()), 12, replace=False)]
    seeds = np.concatenate([seeds, seeds[:3]])
    out = {}
    for device in ("cuda", "cpu"):
        d, f = tgeodesic.voronoi_feature_field(
            torch.from_numpy(ok).to(device), seeds, ANIS)
        out[device] = (d.cpu(), f.cpu())
    _assert_bit_equal(out["cuda"], out["cpu"])


# V1's lane-batched form: lanes of mixed extents (n = 0, n = 1, H = 1,
# W = 1, full), planes on both sides of its shape rule, one lane against
# many, lanes with `active` off
def _batched_case(name, cap):
    rng = np.random.RandomState(7)
    if name == "mixed":
        B, N, H, W = 7, 9, 21, 19
        ext = [(9, 21, 19), (1, 21, 19), (9, 1, 19), (9, 21, 1), (0, 5, 5),
               (4, 7, 3), (6, 20, 18)]
    elif name == "one":
        B, N, H, W = 1, 13, 37, 45
        ext = [(13, 37, 45)]
    elif name == "many":
        B, N, H, W = 300, 6, 9, 11
        ext = np.stack([rng.randint(1, N + 1, B), rng.randint(1, H + 1, B),
                        rng.randint(1, W + 1, B)], 1)
    elif name == "inactive":
        B, N, H, W = 8, 7, 16, 16
        ext = [(7, 16, 16)] * B
    else:  # the plane of the shape rule's edge
        B, N, H = 2, 3, 100
        W = cap // H
        ext = [(N, H, W), (N - 1, H, W - 1)]
    active = (torch.arange(B, device="cuda") % 2 == 0
              if name == "inactive" else None)
    return (B, N, H, W), torch.tensor(np.asarray(ext), dtype=torch.int32), \
        active


@pytest.mark.parametrize("name", ("mixed", "one", "many", "inactive",
                                  "shared"))
@pytest.mark.parametrize("ties", (False, True))
def test_voronoi_sweep_batched_kernel_matches_plain(gen, name, ties):
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    cap = tvoronoi.voronoi_batched_plan(1, 1, 1)["capacity"]
    shape, ext, active = _batched_case(name, cap)
    d, f, ok = _voronoi_inputs(gen, shape, ties)
    anis = (1.0, 1.0, 1.0) if ties else ANIS
    for desc in (False, True):
        costs = tgeodesic.plane_costs(0, desc, anis)
        runs = []
        for _ in range(2):
            gd, gf = d.clone(), f.clone()
            flag = torch.zeros(shape[0], dtype=torch.int32, device="cuda")
            before = kernels.LAUNCHES["voronoi_sweep_batched"]
            tvoronoi.voronoi_sweep_batched(gd, gf, ok, ext, costs, desc,
                                           flag, active)
            assert kernels.LAUNCHES["voronoi_sweep_batched"] == before + 1
            runs.append((gd, gf, flag))
        wd, wf = d.clone(), f.clone()
        want_flag = torch.zeros(shape[0], dtype=torch.int32, device="cuda")
        tvoronoi._voronoi_sweep_lanes_plain(
            wd, wf, ok, tvoronoi.VoronoiLanes.batched(shape, ext), costs,
            desc, want_flag, active)
        _assert_bit_equal(runs[0], (wd, wf, want_flag))
        _assert_bit_equal(runs[1], runs[0])
        assert int(want_flag.sum()) > 0
        # a second sweep of the output changes nothing, flags stay 0
        still = torch.zeros_like(want_flag)
        tvoronoi.voronoi_sweep_batched(wd, wf, ok, ext, costs, desc, still,
                                       active)
        assert int(still.sum()) == 0
        _assert_bit_equal((wd, wf), runs[0][:2])


def test_voronoi_batched_plan_follows_the_shape_rule(gen):
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    plan = tvoronoi.voronoi_batched_plan(1, 1, 1)
    cap = plan["capacity"]
    assert plan["threads"] == 1024 and cap >= 100 * 100
    edge = tvoronoi.voronoi_batched_plan(5, 100, cap // 100)
    assert edge["form"] == "shared" and edge["ctas"] == 5
    beyond = tvoronoi.voronoi_batched_plan(5, 100, cap // 100 + 1)
    assert beyond["form"] == "single" and beyond["ctas"] == 0
    small = tvoronoi.voronoi_batched_plan(100, 10, 10)
    assert small["form"] == "shared" and small["lanes"] == 32
    assert small["ctas"] == 4


def test_voronoi_sweep_batched_refuses_a_plane_beyond_one_cta(gen):
    """A lane whose plane exceeds one CTA's shared memory is refused
    before any launch; the same lane with no extent is not swept."""
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    cap = tvoronoi.voronoi_batched_plan(1, 1, 1)["capacity"]
    shape = (2, 3, 100, cap // 100 + 1)
    d, f, ok = _voronoi_inputs(gen, shape, False)
    costs = tgeodesic.plane_costs(0, False, ANIS)
    flag = torch.zeros(2, dtype=torch.int32, device="cuda")
    before = kernels.LAUNCHES["voronoi_sweep_batched"]
    with pytest.raises(ValueError, match="beyond"):
        tvoronoi.voronoi_sweep_batched(d, f, ok, [(3, 100, cap // 100 + 1),
                                                  (1, 2, 2)], costs, False,
                                       flag)
    assert kernels.LAUNCHES["voronoi_sweep_batched"] == before
    tvoronoi.voronoi_sweep_batched(d, f, ok, [(0, 100, cap // 100 + 1),
                                              (3, 2, 2)], costs, False, flag)
    assert kernels.LAUNCHES["voronoi_sweep_batched"] == before + 1


def test_voronoi_feature_field_batched_sends_large_planes_alone(gen):
    """Crops on both sides of the shape rule in one call: the one whose
    axis-2 plane (X x Y) exceeds one CTA's shared memory takes V1's
    single-volume forms, the others the batched kernel; every field
    equals the CPU's."""
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    cap = tvoronoi.voronoi_batched_plan(1, 1, 1)["capacity"]
    rng = np.random.RandomState(9)
    oks, seeds = [], []
    for shape in ((100, cap // 100 + 1, 3), (100, cap // 100, 3),
                  (20, 30, 40)):
        ok = rng.rand(*shape) < 0.8
        pts = np.argwhere(ok)
        oks.append(ok)
        seeds.append(pts[rng.choice(len(pts), 5, replace=False)])
    kernels.reset_launches()
    got = tgeodesic.voronoi_feature_field_batched(oks, seeds, ANIS)
    assert kernels.LAUNCHES["voronoi_sweep_batched"] > 0
    assert kernels.LAUNCHES["voronoi_sweep"] > 0
    for ok, s, (d, f) in zip(oks, seeds, got):
        want = tgeodesic.voronoi_feature_field(ok, s, ANIS, device="cpu")
        _assert_bit_equal((d.cpu(), f.cpu()), want)


def test_voronoi_feature_field_batched_cuda_matches_cpu(gen):
    rng = np.random.RandomState(6)
    oks, seeds = [], []
    for shape in ((40, 33, 21), (17, 16, 1), (5, 64, 30), (1, 1, 1),
                  (30, 30, 30)):
        ok = rng.rand(*shape) < 0.8
        pts = np.argwhere(ok)
        pick = pts[rng.choice(len(pts), min(6, len(pts)), replace=False)]
        oks.append(ok)
        seeds.append(np.concatenate([pick, pick[:1], [(-1, 0, 0)]]))
    before = kernels.LAUNCHES["voronoi_sweep_batched"]
    got = tgeodesic.voronoi_feature_field_batched(oks, seeds, ANIS)
    assert kernels.LAUNCHES["voronoi_sweep_batched"] > before
    for ok, s, (d, f) in zip(oks, seeds, got):
        assert d.device.type == "cuda"
        want = tgeodesic.voronoi_feature_field(ok, s, ANIS, device="cpu")
        _assert_bit_equal((d.cpu(), f.cpu()), want)


def _tube64():
    """A winding tube of radius 2 in 64^3 and its two ends."""
    rng = np.random.RandomState(5)
    p, h = np.array([32.0, 32.0, 32.0]), rng.randn(3)
    pts = []
    for _ in range(160):
        h = h / np.linalg.norm(h) + 0.5 * rng.randn(3)
        p = np.clip(p + h / np.linalg.norm(h), 4, 59)
        pts.append(p.copy())
    g = np.indices((64, 64, 64)).transpose(1, 2, 3, 0)
    vol = np.zeros((64, 64, 64), dtype=bool)
    for q in pts:
        vol |= ((g - q) ** 2).sum(-1) <= 4.0
    return vol, (tuple(int(round(c)) for c in pts[0]),
                 tuple(int(round(c)) for c in pts[-1]))


def test_connect_points_cuda_matches_cpu(gen):
    vol, (start, end) = _tube64()
    out = {}
    for device in ("cuda", "cpu"):
        before = kernels.LAUNCHES["sweep_axis0"]
        out[device] = kimimaro_tpu_torch.connect_points(
            vol, start, end, anisotropy=(16, 16, 40), device=device)
        if device == "cuda":
            assert kernels.LAUNCHES["sweep_axis0"] > before
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.radii, b.radii)


def test_oversegment_cuda_matches_cpu(gen):
    rng = np.random.RandomState(2)
    seeds = rng.randint(0, 64, size=(6, 3)).astype(np.float32)
    g = np.indices((64, 64, 64)).reshape(3, -1).T.astype(np.float32)
    w = np.array([16.0, 16.0, 40.0], np.float32)
    d2 = (((g[:, None, :] - seeds[None]) * w) ** 2).sum(-1)
    vol = (np.argmin(d2, axis=1) + 1).astype(np.uint32).reshape(64, 64, 64)
    vol[rng.rand(64, 64, 64) < 0.02] = 0
    tp = {"scale": 1.5, "const": 300, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 1e9,
          "soma_acceptance_threshold": 1e9}
    skels = kimimaro_tpu_torch.skeletonize(vol, teasar_params=tp,
                                           anisotropy=(16, 16, 40),
                                           dust_threshold=100, device="cpu")
    assert len(skels) >= 4
    for ds in (0, 5):
        out = {}
        for device in ("cuda", "cpu"):
            before = kernels.LAUNCHES["voronoi_sweep_batched"]
            out[device] = kimimaro_tpu_torch.oversegment(
                vol, skels, anisotropy=(16, 16, 40), downsample=ds,
                device=device)
            if device == "cuda":
                assert kernels.LAUNCHES["voronoi_sweep_batched"] > before
        (la, sa), (lb, sb) = out["cuda"], out["cpu"]
        np.testing.assert_array_equal(la, lb)
        for k in sa:
            np.testing.assert_array_equal(sa[k].segments, sb[k].segments)


# --------------------------------------------------------------------------- #
# the multi-device path (shards sharing the card)


def _sharded_blobs():
    rng = np.random.RandomState(5)
    shape = (40, 36, 30)
    vol = np.zeros(shape, dtype=np.uint32)
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for lab in range(1, 7):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        vol[((e + rng.rand(*shape) * 0.4) < 1.0) & (vol == 0)] = lab
    return vol


@pytest.mark.parametrize("n", (2, 4))
def test_skeletonize_sharded_cuda_matches_cpu(gen, n):
    from kimimaro_tpu_torch.parallel import make_mesh, skeletonize_sharded

    vol = _sharded_blobs()
    teasar = dict(kimimaro_tpu_torch.DEFAULT_TEASAR_PARAMS, const=30,
                  soma_detection_threshold=1e9, soma_acceptance_threshold=1e9)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = skeletonize_sharded(
            vol, mesh=make_mesh(n, device), teasar_params=teasar,
            anisotropy=ANIS, dust_threshold=10)
    assert sorted(out["cuda"]) == sorted(out["cpu"]) and len(out["cpu"]) >= 3
    for k in out["cpu"]:
        assert out["cuda"][k].to_swc() == out["cpu"][k].to_swc()


@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood", "minid"))
def test_sweep0_slab_with_halo_each_side_of_the_rule(gen, mode):
    """B1 on a slab extended by a halo plane (the sharded relaxes' plane 0,
    cc -1 where unoccupied), at the planes on each side of sweep0_plan's
    rule (no okmask, as the sharded path sweeps)."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the plane sizes are those of a 132-SM card")
    for persistent in (True, False):
        side = _smem_limit(mode, False, persistent)
        assert tgsweep.sweep0_plan(side, side, mode, False)["persistent"] \
            == persistent
        d, cc, nc, _ = _sweep0_inputs(gen, (4, side, side), mode)
        if mode != "minid":
            cc[0] = torch.where(cc[0] > 0, cc[0], -1)
        for clamp in (False, True):
            for desc in (False, True):
                got = tgsweep.sweep0(d, cc, nc, None, ANIS, mode, clamp, desc)
                want = tgsweep._sweep0_plain(d, cc, nc, None, ANIS, mode,
                                             clamp, desc)
                _assert_bit_equal((got,), (want,))


def test_crop_argmax_with_boxes_cut_to_slabs_matches_cpu(gen):
    """The sharded engine's argmax: B3 on each slab with each lane's window
    cut into the slab and its box cut to the slab's rows, combined across
    slabs; the card's answers equal the CPU's."""
    from kimimaro_tpu_torch.parallel import gengine as tg
    from kimimaro_tpu_torch.parallel import make_mesh

    shape, h = (64, 40, 36), 16
    cc = torch.randint(0, 6, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    field = torch.round(_rand(gen, shape) * 4)
    field = torch.where(cc == 0, float("-inf"), field)
    rng = np.random.RandomState(1)
    n = 24
    crops = np.array([(32, 16, 16)] * (n // 2) + [(64, 40, 36)] * (n // 2))
    offs = np.stack([rng.randint(0, 64 - crops[:, 0] + 1),
                     rng.randint(0, 40 - crops[:, 1] + 1),
                     rng.randint(0, 36 - crops[:, 2] + 1)], axis=1)
    size = np.stack([rng.randint(0, c + 1) for c in crops.T], axis=1)
    size[::5] = 0
    box_off = offs + np.stack([rng.randint(0, c - s + 1)
                               for c, s in zip(crops.T, size.T)], axis=1)
    lids = torch.tensor(rng.randint(1, 7, n), dtype=torch.int32)
    out = {}
    for device in ("cuda", "cpu"):
        mesh = make_mesh(4, device)
        out[device] = tg._slab_argmax(
            [field[i * h:(i + 1) * h].to(device) for i in range(4)],
            [cc[i * h:(i + 1) * h].to(device) for i in range(4)],
            offs, crops, (box_off, size), lids.to(device), mesh, h,
            shape[1:])
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g.cpu(), w)


# C1 at the crop shapes of the benchmark's lane sets, with a path buffer of
# 2 * sum(crop) rows as the crop engine gives it
CHASE_CROPS = ((64, 64, 32), (32, 128, 128), (128, 128, 64))


def _chase_lanes(gen, B, crop):
    """Padded rail fields and starts of B lanes, a kind by lane index mod 4:
    0, a descending field of many exact ties (the Chebyshev distance to
    three rail voxels) with +inf holes and +inf padding; 1, all +inf
    (every window steps to offset 0); 2, small positive integers and a few
    NaN, no rail (the walk runs to the buffer's end); 3, kind 0 with finite
    padding and a start on the padded edge or outside it, negative
    coordinates included."""
    P = tuple(c + 2 for c in crop)
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(n, device="cuda") for n in P], indexing="ij"), -1)
    hi = torch.tensor(crop, device="cuda")
    d = torch.empty((B,) + P, device="cuda")
    start = torch.empty((B, 3), dtype=torch.int64, device="cuda")
    for b in range(B):
        kind = b % 4
        if kind in (0, 3):
            rails = (torch.rand((3, 1, 1, 1, 3), generator=gen,
                                device="cuda") * hi).long() + 1
            f = (idx - rails).abs().amax(dim=-1).amin(dim=0).float()
            f = torch.where(_rand(gen, P) < 0.1, float("inf"), f)
            if kind == 0:
                f[0], f[-1] = float("inf"), float("inf")
                f[:, 0], f[:, -1] = float("inf"), float("inf")
                f[..., 0], f[..., -1] = float("inf"), float("inf")
        elif kind == 1:
            f = torch.full(P, float("inf"), device="cuda")
        else:
            f = torch.randint(1, 4, P, generator=gen, device="cuda").float()
            f = torch.where(_rand(gen, P) < 0.01, float("nan"), f)
        d[b] = f
        if kind == 3:
            lo = torch.tensor([-3, -3, -3], device="cuda")
            top = hi + 3
        else:
            lo, top = torch.zeros(3, dtype=torch.int64, device="cuda"), hi
        start[b] = lo + (torch.rand(3, generator=gen, device="cuda")
                         * (top - lo)).long()
    return d, start


def _chase_graph(gen, shape, kind):
    """Random voxel-graph words, about three bits in four set, as int32 or
    as the same bits in uint32; None for kind None."""
    if kind is None:
        return None
    words = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(2)]
    vg = words[0] | words[1]
    return vg.view(torch.uint32) if kind == "uint32" else vg


@pytest.mark.parametrize("graph", (None, "uint32", "int32"))
@pytest.mark.parametrize("crop", CHASE_CROPS)
@pytest.mark.parametrize("B", (1, 7, 64))
def test_chase_kernel_matches_plain(gen, B, crop, graph):
    """C1 walks every lane as the plain version does, bit for bit (path,
    length, rail flag), twice, in one launch a call counted under its
    form; lanes that reach a rail, run to the buffer's end, start outside
    the crop or see only +inf are mixed in one launch."""
    d, start = _chase_lanes(gen, B, crop)
    vg = _chase_graph(gen, d.shape, graph)
    L = 2 * sum(crop)
    name = "chase_batched" if graph is None else "chase_batched_vg"
    before = kernels.LAUNCHES[name]
    got = tchase.chase_batched(d, start, L, vg)
    assert kernels.LAUNCHES[name] == before + 1
    again = tchase.chase_batched(d, start, L, vg)
    want = tchase._chase_batched_plain(d, start, L, vg)
    _assert_bit_equal(got, want)
    _assert_bit_equal(again, got)
    if B >= 4:
        # each kind is in the launch: rails reached, buffers run out
        reached, plen = want[2].cpu(), want[1].cpu()
        assert reached[0::4].any() and not reached[1::4].any()
        assert (plen[2::4] == L).all()


@pytest.mark.parametrize("graph", (None, "uint32", "int32"))
def test_chase_kernel_matches_jax_fixture(gen, graph):
    """C1 equals the JAX package's vmapped chase exactly on the lanes of
    tests/data/chase_jax.npz (walks that leave the crop, all +inf windows,
    exact ties, no rail), stored with JAX's output by
    tests/test_torch_chase.py, which checks them against JAX."""
    from pathlib import Path

    with np.load(Path(__file__).resolve().parent / "data"
                 / "chase_jax.npz") as f:
        fx = dict(f)
    vg = None if graph is None else torch.from_numpy(
        fx["vg"] if graph == "uint32" else fx["vg"].view(np.int32)).cuda()
    tag = "plain" if graph is None else "vg"
    name = "chase_batched" if graph is None else "chase_batched_vg"
    before = kernels.LAUNCHES[name]
    got = tchase.chase_batched(torch.from_numpy(fx["d_pad"]).cuda(),
                               torch.from_numpy(fx["start"]).cuda(),
                               int(fx["max_len"]), vg)
    assert kernels.LAUNCHES[name] == before + 1
    for k, a in zip(("path", "length", "reached"), got):
        assert a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), fx[f"{k}_{tag}"])


def test_chase_cuda_never_takes_the_plain_loop(gen, monkeypatch):
    """chase_batched on CUDA tensors launches C1 or raises: the plain loop
    is never reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain chase ran on CUDA tensors")

    d, start = _chase_lanes(gen, 4, (16, 12, 10))
    monkeypatch.setattr(tchase, "_chase_batched_plain", refuse)
    for vg in (None, _chase_graph(gen, d.shape, "int32")):
        path, plen, reached = tchase.chase_batched(d, start, 76, vg)
        assert path.shape == (4, 76, 3) and plen.shape == (4,)
    with pytest.raises(TypeError):
        tchase.chase_batched(d.double(), start, 76)

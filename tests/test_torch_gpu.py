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
from kimimaro_tpu_torch.ops import crop_argmax as tcrop
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops import sweep as tsweep

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


@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood", "minid"))
def test_sweep0_kernel_matches_plain(gen, mode, descending):
    cc = torch.randint(0, 4, SHAPE, generator=gen, device="cuda",
                       dtype=torch.int32)
    if mode == "minid":
        cc = torch.where(cc == 3, -7, cc)
        d = torch.where(cc != 0, (_rand(gen) * 999).to(torch.int32) + 1,
                        2**31 - 1).to(torch.int32)
    elif mode == "maxflood":
        d = torch.where(cc > 0, _rand(gen) * 10, float("-inf"))
    else:
        d = torch.where(_rand(gen) < 0.25, _rand(gen) * 10 - 5, float("inf"))
    nc = _rand(gen) * 3 if mode == "node" else None
    ok = (_rand(gen) < 0.8).to(torch.uint8)
    for clamp in (False, True):
        before = kernels.LAUNCHES["gsweep_sweep0"]
        got = tgsweep.sweep0(d, cc, nc, ok, ANIS, mode, clamp, descending)
        assert kernels.LAUNCHES["gsweep_sweep0"] == before + 1
        want = tgsweep._sweep0_plain(d, cc, nc, ok, ANIS, mode, clamp,
                                     descending)
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


@pytest.mark.parametrize("node_mode", (False, True))
def test_sweep_axis0_kernel_matches_plain(gen, node_mode):
    d = torch.where(_rand(gen) < 0.25, _rand(gen) * 10 - 5, float("inf"))
    ok = _rand(gen) < 0.8
    nc = _rand(gen) * 3
    for clamp in (False, True):
        for desc in (False, True):
            got = tsweep.sweep_axis0(d, ok, nc, ANIS, node_mode, clamp, desc)
            want = tsweep._sweep_axis0_plain(d, ok, nc, ANIS, node_mode,
                                             clamp, desc)
            _assert_bit_equal((got,), (want,))


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
                before = kernels.LAUNCHES["sweep_axis0_batched"]
                got = tsweep.sweep_axis0_batched(d, ok, nc, ANIS, node_mode,
                                                 clamp, desc, vg=g, bits9=b)
                assert kernels.LAUNCHES["sweep_axis0_batched"] == before + 1
                want = tsweep._sweep_axis0_batched_plain(
                    d, ok, nc, ANIS, node_mode, clamp, desc, g, b)
                _assert_bit_equal((got,), (want,))


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


@pytest.mark.parametrize("method,W,rounds", [
    ("dilate", 13, 2), ("dilate", 32, 36), ("dilate", 100, 8),
    ("dilate", 130, 4), ("sweep", 13, 0), ("sweep", 64, 6),
    ("sweep", 128, 6), ("sweep", 200, 3)])
def test_section_flood_kernel_matches_plain(gen, method, W, rounds):
    """X1 in shared memory (small windows) and in device memory (the
    dilation above 64, the sweep above 128), lanes that converge and lanes
    that run out of rounds."""
    from kimimaro_tpu_torch.ops import xsslab

    seed, secb, zb = _xs_windows(W, 5, W, W - 3)
    before = kernels.LAUNCHES["section_flood"]
    got = xsslab.section_flood(seed, secb, zb, rounds, method)
    assert kernels.LAUNCHES["section_flood"] == before + 1
    want = xsslab._section_flood_plain(seed, secb, zb, rounds, method)
    _assert_bit_equal(got, want)


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

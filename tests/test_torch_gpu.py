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
    """X1's dilation in shared memory (small windows) and in device memory
    (above 64), its sweep in shared memory, lanes that converge and lanes
    that run out of rounds."""
    from kimimaro_tpu_torch.ops import xsslab

    seed, secb, zb = _xs_windows(W, 5, W, W - 3)
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
            before = kernels.LAUNCHES["sweep_axis0_batched"]
            got = tsweep.sweep_axis0_batched(d, ok, nc, ANIS, node_mode,
                                             False, True, vg=g, bits9=b)
            assert kernels.LAUNCHES["sweep_axis0_batched"] == before + 1
            want = tsweep._sweep_axis0_batched_plain(
                d, ok, nc, ANIS, node_mode, False, True, g, b)
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

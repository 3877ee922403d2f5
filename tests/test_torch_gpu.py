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


@pytest.mark.parametrize("kind", ("ball_rail", "max2"))
def test_sweep0_dual_kernel_matches_plain(gen, kind):
    cc = torch.randint(0, 4, SHAPE, generator=gen, device="cuda",
                       dtype=torch.int32)
    if kind == "ball_rail":
        da = torch.where(_rand(gen) < 0.2, -_rand(gen) * 60, float("inf"))
        db = torch.where(_rand(gen) < 0.2, _rand(gen), float("inf"))
        nc, ok = _rand(gen) * 3, (_rand(gen) < 0.8).to(torch.uint8)
    else:
        da = torch.where(cc > 0, _rand(gen), float("-inf"))
        db = torch.where(cc > 0, _rand(gen) * 7, float("-inf"))
        nc = ok = None
    for desc in (False, True):
        got = tgsweep.sweep0_dual(da, db, cc, nc, ok, ANIS, kind, desc)
        want = tgsweep._sweep0_dual_plain(da, db, cc, nc, ok, ANIS, kind,
                                          desc)
        _assert_bit_equal(got, want)


def test_crop_argmax_kernel_matches_plain(gen):
    shape, crop = (40, 36, 30), (16, 12, 10)
    cc = torch.randint(0, 5, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    field = torch.round(_rand(gen, shape) * 3)
    field = torch.where(cc == 4, float("-inf"), field).contiguous()
    hi = torch.tensor([s - c for s, c in zip(shape, crop)], device="cuda")
    offs = (_rand(gen, (64, 3)) * (hi + 1)).floor().to(torch.int32)
    lids = torch.tensor([1, 2, 3, 0, 4, 9], dtype=torch.int32,
                        device="cuda").repeat(11)[:64].contiguous()
    got = tcrop.crop_argmax(field, cc, offs.contiguous(), lids, crop)
    want = tcrop._crop_argmax_plain(field, cc, offs, lids, crop)
    _assert_bit_equal(got, want)


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

"""Fused multiply-adds: XLA:CPU contracts an elementwise f32 `a*b + c`
into one fused multiply-add, so the port computes those lines with
kimimaro_tpu_torch.ops.fma.fma_f32.

`fma_f32` against jax.jit(lambda a, b, c: a*b + c); the skeletons, the
PDRF and the invalidation radii of a volume on which a plain f32
multiply-add moves a vertex against the JAX
package's, through the global engine, the crop engine and the host trace
path (the PDRF and the radii captured where each package hands them to
its relaxation)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu import engine as jengine
from kimimaro_tpu import trace as jtrace
from kimimaro_tpu.ops import fused_trace as jfused
from kimimaro_tpu.ops import gsweep as jgsweep
from kimimaro_tpu.utils import progcache
from kimimaro_tpu_torch import engine as tengine
from kimimaro_tpu_torch import gengine as tgengine
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops import xsslab as txsslab
from kimimaro_tpu_torch.ops.fma import fma_f32

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)
TEASAR = {
    "scale": 1.5,
    "const": 30,
    "pdrf_exponent": 4,
    "pdrf_scale": 100000,
    "soma_detection_threshold": 1e9,
    "soma_acceptance_threshold": 1e9,
}
# the default radius parameters, where a plain f32 radius differs from
# the fused one on some DBF values of this volume
TEASAR_10 = dict(TEASAR, scale=10, const=10)


def _triples(n, seed):
    """Random f32 triples, and triples whose exact a*b + c lies at or next
    to a midpoint between two f32 values: 13-bit mantissas (an exact
    product of at most 26 bits) and a c far below the product's ulp, which
    a float64 sum rounds away (the case a plain float64 form double-rounds
    wrongly)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    m1 = rng.integers(1 << 12, 1 << 13, n).astype(np.float64)
    m2 = rng.integers(1 << 12, 1 << 13, n).astype(np.float64)
    a2 = np.ldexp(m1, rng.integers(-32, -4, n)).astype(np.float32)
    b2 = np.ldexp(m2, rng.integers(-32, -4, n)).astype(np.float32)
    a2 = np.where(rng.random(n) < 0.5, -a2, a2).astype(np.float32)
    p = a2.astype(np.float64) * b2
    c2 = (np.where(rng.random(n) < 0.5, -1.0, 1.0) * np.abs(p)
          * np.ldexp(1.0, -rng.integers(30, 60, n))).astype(np.float32)
    return (np.concatenate([a, a2]), np.concatenate([b, b2]),
            np.concatenate([c, c2]))


def test_fma_f32_matches_xla():
    """Bit-equal to XLA's fused multiply-add on 2^21 triples (half of them
    at f32 midpoints); a plain f32 form and a float64 form rounded once
    each differ on some."""
    a, b, c = _triples(1 << 20, seed=0)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain32 = a * b + c
    plain64 = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (plain32 != want).sum() > 1000
    assert (plain64 != want).sum() > 100
    # broadcasting, Python float operands, and the chunked path
    x = torch.from_numpy(a[:4096].reshape(64, 64))
    np.testing.assert_array_equal(
        fma_f32(x, 10.0, 10.0).numpy(),
        np.asarray(jax.jit(lambda x: x * np.float32(10) + np.float32(10))(
            x.numpy())))
    big = torch.from_numpy(np.tile(a[:1 << 18], 80).reshape(80, -1))
    np.testing.assert_array_equal(
        fma_f32(big, big, 1.0).numpy(),
        fma_f32(big.reshape(-1), big.reshape(-1), 1.0).numpy().reshape(80, -1))


def _fma_volume():
    """_blob_volume(seed=5) of tests/test_torch_skeletonize.py with label 3
    set to 1: blob 3 joins blob 1 in one component of 979 voxels."""
    shape = (40, 36, 30)
    rng = np.random.RandomState(5)
    vol = np.zeros(shape, dtype=np.uint32)
    for lab in range(1, 7):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        noise = rng.rand(*shape) * 0.4
        m = (e + noise) < 1.0
        vol[m & (vol == 0)] = lab
    vol[vol == 3] = 1
    return vol


def _label_inputs(vol, lab):
    """cc, DBF and the one job of label `lab` alone, as the intake builds
    them for the engines."""
    one = (vol == lab).astype(np.int32)
    dbf = np.asarray(kimimaro_tpu.ops.edt.edt(jnp.asarray(one),
                                               anisotropy=ANIS,
                                               black_border=False))
    dbf = np.where(one != 0, dbf, 0.0).astype(np.float32)
    pts = np.argwhere(one)
    mn, mx = pts.min(axis=0), pts.max(axis=0)
    job = {"segid": 1, "offset": mn.astype(np.int64),
           "shape": (mx - mn + 1).astype(np.int64), "before": [],
           "after": [], "root": None, "count": len(pts),
           "dbfmax": float(dbf.max())}
    return one, dbf, job


def _same_skeletons(a, b):
    assert set(a) == set(b)
    for k in a:
        va = a[k].vertices[np.lexsort(a[k].vertices.T)]
        vb = b[k].vertices[np.lexsort(b[k].vertices.T)]
        np.testing.assert_array_equal(va, vb)
        ra = {tuple(v): r for v, r in zip(a[k].vertices, a[k].radii)}
        rb = {tuple(v): r for v, r in zip(b[k].vertices, b[k].radii)}
        assert ra == rb


@pytest.mark.parametrize("fix_branching", (True, False))
def test_fma_volume_global_engine_matches_jax(fix_branching):
    """The five-label volume through the global engine: the same
    skeletons (label 1's differed by a vertex with plain f32 PDRFs)."""
    vol = _fma_volume()
    kw = dict(teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
              fix_branching=fix_branching)
    want = kimimaro_tpu.skeletonize(vol, **kw)
    got = kimimaro_tpu_torch.skeletonize(vol, device="cpu", **kw)
    assert len(got) == 5
    _same_skeletons(want, got)


@pytest.mark.parametrize("fix_branching", (True, False))
def test_fma_volume_crop_engine_matches_jax(fix_branching):
    """Label 1 alone through both crop engines: the same paths and radii."""
    one, dbf, job = _label_inputs(_fma_volume(), 1)
    want, want_fb = jengine.trace_batched(
        jnp.asarray(one), jnp.asarray(dbf), [job], TEASAR, ANIS,
        fix_branching)
    got, got_fb = tengine.trace_batched(
        torch.from_numpy(one), torch.from_numpy(dbf), [job], TEASAR, ANIS,
        fix_branching)
    assert not want_fb and not got_fb
    assert len(got[1]) == len(want[1]) > 1
    for (gv, gr), (wv, wr) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gr, wr)


class _Capture:
    """Values each package hands to its relaxations, by kind, in call
    order: the JAX side through jax.debug.callback inside its jitted code,
    the port's directly."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.jax = {}
        self.port = {}
        jax.clear_caches()  # retrace with the wrappers below
        monkeypatch.setattr(progcache, "call",
                            lambda name, fn, statics, *a, **k: fn(*a,
                                                                   **statics))

    def _put(self, side, kind, x):
        side.setdefault(kind, []).append(np.array(x, copy=True))

    def jax_arg(self, mod, name, pick):
        inner = getattr(mod, name)

        def wrapper(*a, **k):
            got = pick(a, k)
            if got is not None:
                kind, x = got
                jax.debug.callback(
                    lambda v, kind=kind: self._put(self.jax, kind, v), x)
            return inner(*a, **k)

        self.mp.setattr(mod, name, wrapper)

    def port_arg(self, mod, name, pick):
        inner = getattr(mod, name)

        def wrapper(*a, **k):
            got = pick(a, k)
            if got is not None:
                self._put(self.port, got[0], got[1].numpy())
            return inner(*a, **k)

        self.mp.setattr(mod, name, wrapper)

    def out(self, mod, name, kind, which, jax_side):
        inner = getattr(mod, name)

        def wrapper(*a, **k):
            r = inner(*a, **k)
            v = which(r)
            self._put(self.jax if jax_side else self.port, kind,
                      np.asarray(v) if jax_side else v.numpy())
            return r

        self.mp.setattr(mod, name, wrapper)

    def assert_equal(self, kind, skip_last_voxel=False):
        jax.effects_barrier()
        want, got = self.jax.get(kind, []), self.port.get(kind, [])
        assert got and len(want) >= len(got), (kind, len(want), len(got))
        for w, g in zip(want, got):
            w, g = w.reshape(g.shape).copy(), g.copy()
            if skip_last_voxel:
                w.reshape(-1)[-1] = g.reshape(-1)[-1] = 0
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32), err_msg=kind)


def _ball_init(a, k):
    return ("ball", a[0]) if k.get("clamp_positive") else None


@pytest.mark.parametrize("teasar", (TEASAR, TEASAR_10),
                         ids=("scale1.5", "scale10"))
def test_fma_volume_pdrf_and_radii_match_jax(monkeypatch, teasar):
    """On that volume, voxel for voxel: the global engine's PDRF and the
    seeds of its invalidation balls (-radius at each path voxel); the
    crop engine's PDRF (its rail relaxation's nodecost) and ball seeds;
    the host trace path's PDRF and ball seeds. The host path's balls skip
    the crop's far corner: the JAX package's fused path loop seeds its
    padding rows there, the port's host loop does not."""
    vol = _fma_volume()
    cap = _Capture(monkeypatch)
    # global engine
    cap.out(tgengine, "_pdrf_rail_phase", "gpdrf", lambda r: r[0], False)
    inner_call = progcache.call

    def record_pdrf(name, fn, statics, *a, **k):
        r = inner_call(name, fn, statics, *a, **k)
        if name == "gengine_pdrf_rail":
            cap._put(cap.jax, "gpdrf", np.asarray(r[0]))
        return r

    monkeypatch.setattr(progcache, "call", record_pdrf)
    cap.jax_arg(jgsweep, "relax_escalated_dual", lambda a, k: ("gball", a[0]))
    cap.port_arg(tgsweep, "relax_escalated_dual",
                 lambda a, k: ("gball", a[0]))
    cap.jax_arg(jgsweep, "relax_escalated",
                lambda a, k: ("gball", a[0]) if k.get("clamp_positive")
                else None)
    cap.port_arg(tgsweep, "relax_escalated",
                 lambda a, k: ("gball", a[0]) if k.get("clamp_positive")
                 else None)
    kw = dict(teasar_params=teasar, anisotropy=ANIS, dust_threshold=10)
    _same_skeletons(kimimaro_tpu.skeletonize(vol, **kw),
                    kimimaro_tpu_torch.skeletonize(vol, device="cpu", **kw))
    cap.assert_equal("gpdrf")
    cap.assert_equal("gball")

    # crop engine (label 1 alone: one lane)
    one, dbf, job = _label_inputs(vol, 1)
    cap.jax_arg(jengine, "_relax_rounds",
                lambda a, k: ("cball", a[0]) if k.get("clamp_positive")
                else (("crail", a[2]) if a[2] is not None else None))
    cap.port_arg(tengine, "relax_rounds_batched",
                 lambda a, k: ("cball", a[0]) if k.get("clamp_positive")
                 or (len(a) > 5 and a[5])
                 else (("crail", a[2]) if a[2] is not None else None))
    jengine.trace_batched(jnp.asarray(one), jnp.asarray(dbf), [job], teasar,
                          ANIS, True)
    tengine.trace_batched(torch.from_numpy(one), torch.from_numpy(dbf),
                          [job], teasar, ANIS, True)
    cap.assert_equal("crail")
    cap.assert_equal("cball")

    # host trace path on the label's crop
    sl = tuple(slice(o, o + s) for o, s in zip(job["offset"], job["shape"]))
    lab, d = one[sl], np.where(one[sl] != 0, dbf[sl], 0).astype(np.float32)
    cap.out(jtrace, "_pdrf_kernel", "hpdrf", lambda r: r, True)
    cap.out(ttrace, "_pdrf_kernel", "hpdrf", lambda r: r, False)
    cap.jax_arg(jfused, "_relax_rounds",
                lambda a, k: ("hball", a[0]) if k.get("clamp_positive")
                else None)
    cap.port_arg(ttrace, "relax_rounds_batched",
                 lambda a, k: ("hball", a[0][0]) if k.get("clamp_positive")
                 else None)
    ws = jtrace.trace(lab, d, anisotropy=ANIS, **teasar)
    gs = ttrace.trace(lab, d, anisotropy=ANIS, device="cpu", **teasar)
    np.testing.assert_array_equal(np.sort(gs.vertices, 0),
                                  np.sort(ws.vertices, 0))
    cap.assert_equal("hpdrf")
    cap.assert_equal("hball", skip_last_voxel=True)


def test_section_flood_zb_guard_and_empty_columns():
    """X1 keeps zb as int16 on the card: `check_zb` refuses a zb beyond
    int16 in a column with section cells, and in empty columns any zb
    leaves the flood as it is (its words stay 0)."""
    rng = np.random.RandomState(3)
    B, Wx, Wy = 4, 23, 19
    secb = (rng.randint(0, 32, (B, Wx, Wy))
            & rng.randint(0, 32, (B, Wx, Wy))).astype(np.int32)
    secb[rng.rand(B, Wx, Wy) > 0.7] = 0
    ii, jj = np.meshgrid(np.arange(Wx), np.arange(Wy), indexing="ij")
    zb = (np.floor(rng.uniform(-1, 1, (B, 1, 1)) * ii
                   + rng.uniform(-1, 1, (B, 1, 1)) * jj).astype(np.int32)
          - 2)
    seed = np.zeros_like(secb)
    seed[:, Wx // 2, Wy // 2] = 31
    seed &= secb
    wild = np.where(secb != 0, zb,
                    rng.randint(-2**31, 2**31 - 1, zb.shape)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (seed, secb, zb, wild)]
    for method, rounds in (("sweep", 4), ("dilate", 12)):
        want = txsslab.section_flood(t[0], t[1], t[2], rounds, method)
        got = txsslab.section_flood(t[0], t[1], t[3], rounds, method)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    bad = t[3].clone()
    col = np.argwhere(secb != 0)[0]
    bad[tuple(col)] = 1 << 15
    with pytest.raises(ValueError):
        txsslab.check_zb(t[1], bad)
    bad[tuple(col)] = -(1 << 15) - 1
    with pytest.raises(ValueError):
        txsslab.check_zb(t[1], bad)
    txsslab.check_zb(t[1], t[3])


@pytest.mark.parametrize("z", (40000, 100))
def test_slab_sections_check_zb_on_tall_volumes(z):
    """The slab rungs check zb before X1 on a volume of 2^15 or more along
    the sections' z (below that, zb fits int16 wherever the section is
    not empty): a section cell at z = 40,000 is refused, one at z = 100
    floods."""
    from kimimaro_tpu_torch.ops import xsbatch

    W = 4
    gx, gy = torch.meshgrid(torch.arange(W, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32),
                            indexing="ij")
    raw = torch.full((1, W, W), 31, dtype=torch.int32)
    zb = torch.full((1, W, W), z, dtype=torch.int32)
    # the plane n = (0, 0, 1) through the voxels at z + 2
    a = torch.full((1, W, W), -(z + 2) * 40.0)
    verts = torch.tensor([[1, 1, z + 2]], dtype=torch.int32)
    w0 = torch.zeros(1, dtype=torch.int32)
    args = (raw, gx[None], gy[None], zb, a, torch.tensor([40.0]), verts, w0,
            w0, torch.tensor([[0.0, 0.0, 1.0]]), (16.0, 16.0, 40.0),
            (W, W, 1 << 16), W, W, "sweep", 2)
    if z > txsslab.ZB_MAX:
        with pytest.raises(ValueError):
            xsbatch._finish_section(*args)
    else:
        area, _, conv = xsbatch._finish_section(*args)
        assert float(area[0]) > 0 and bool(conv[0])


def test_global_pdrf_kernel_is_the_global_engines(monkeypatch):
    """gengine.pdrf_kernel, the global engine's PDRF formula taken from a
    label's maxima (the engine cross-checks on the card give it to the
    crop engine and the host trace path), equals the PDRF the global
    engine computes from its broadcast volumes, voxel for voxel on every
    label of the volume."""
    seen = []
    inner = tgengine._pdrf_rail_phase

    def spy(*a, **k):
        r = inner(*a, **k)
        seen.append((a, r[0]))
        return r

    monkeypatch.setattr(tgengine, "_pdrf_rail_phase", spy)
    kimimaro_tpu_torch.skeletonize(_fma_volume(), teasar_params=TEASAR,
                                   anisotropy=ANIS, dust_threshold=10,
                                   device="cpu")
    assert seen
    for (daf, dbf, _, _, cc_v, *_), pdrf in seen:
        ids = torch.unique(cc_v.x[cc_v.x > 0])
        assert len(ids) == 5
        for lab in ids:
            sel = cc_v.x == lab
            d = dbf[sel]
            got = tgengine.pdrf_kernel(
                torch.where(d == 0, float("inf"), d), daf[sel], d.max(),
                TEASAR["pdrf_scale"], TEASAR["pdrf_exponent"],
                daf[sel].max())
            want = pdrf[sel]
            # the root voxel is zeroed after the formula
            keep = want != 0
            np.testing.assert_array_equal(got[keep].numpy().view(np.int32),
                                          want[keep].numpy().view(np.int32))


@pytest.mark.parametrize("max_paths", (2, 3, 5))
def test_host_trace_max_paths_matches_jax(max_paths):
    """The host trace path with three manual targets and max_paths at,
    below and above their count: no path at or below it, as the JAX
    package's fused loop returns none there; above it the same skeleton."""
    one, dbf, job = _label_inputs(_fma_volume(), 1)
    sl = tuple(slice(o, o + s) for o, s in zip(job["offset"], job["shape"]))
    lab, d = one[sl], np.where(one[sl] != 0, dbf[sl], 0).astype(np.float32)
    pts = np.argwhere(lab)
    targets = [tuple(int(c) for c in pts[i])
               for i in (0, len(pts) // 2, len(pts) - 1)]
    kw = dict(TEASAR, anisotropy=ANIS, manual_targets_before=targets,
              max_paths=max_paths)
    want = jtrace.trace(lab, d, **kw)
    got = ttrace.trace(lab, d, device="cpu", **kw)
    assert got.empty() == want.empty() == (max_paths <= len(targets))
    np.testing.assert_array_equal(np.sort(got.vertices, 0),
                                  np.sort(want.vertices, 0))

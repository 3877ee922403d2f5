"""The port's cross sections against the JAX package on the CPU.

Integer outputs are exact: the kept section words, the flood's `changed`
flags, convergence, contact bits and the rung each query converges at.
Per-cell plane areas are exact too (the same f32 operations in the same
order). Summed areas carry rtol=1e-5: the two packages sum the kept
cells' f32 areas in different orders."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu.ops import xsarea as jxsarea
from kimimaro_tpu.ops import xsbatch as jxsbatch
from kimimaro_tpu.ops import xsfetch as jxsfetch
from kimimaro_tpu.ops import xsslab as jxsslab
from kimimaro_tpu.utils import profiling as jprof
from kimimaro_tpu_torch.ops import xsarea as txsarea
from kimimaro_tpu_torch.ops import xsbatch as txsbatch
from kimimaro_tpu_torch.ops import xsfetch as txsfetch
from kimimaro_tpu_torch.ops import xsslab as txsslab
from kimimaro_tpu_torch.skeleton import Skeleton as TSkeleton
from kimimaro_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

K = 5
RTOL = 1e-5  # summed f32 areas: summation order differs


def _random_normals(rng, n):
    m = rng.randn(n, 3).astype(np.float32)
    return (m / np.linalg.norm(m, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("anisotropy", [(16.0, 16.0, 40.0), (1.0, 1.0, 1.0)])
def test_box_plane_area_bit_equal(anisotropy):
    rng = np.random.RandomState(0)
    n = 20000
    normals = _random_normals(rng, n)
    normals[:100] = [1.0, 0.0, 0.0]  # axis-aligned: the midpoint branch
    normals[100:200] = [0.0, 0.6, 0.8]
    t = (rng.randn(n) * max(anisotropy)).astype(np.float32)
    # under jit (as in every jitted caller) XLA fuses the ramp's
    # multiply-add; run eagerly (cross_section_image) it does not
    jitted = jax.jit(jxsarea.box_plane_area, static_argnums=2)
    for fused, fn in ((True, jitted), (False, jxsarea.box_plane_area)):
        want = np.asarray(fn(jnp.asarray(t), jnp.asarray(normals),
                             anisotropy))
        got = txsarea.box_plane_area(torch.from_numpy(t),
                                     torch.from_numpy(normals), anisotropy,
                                     fused=fused)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want > 0).mean() > 0.1


def _random_windows(seed, B=6, Wx=13, Wy=11, density=0.7):
    """Random section words, slab bases (slope <= 1) and one seed cell per
    lane."""
    rng = np.random.RandomState(seed)
    secb = (rng.randint(0, 32, size=(B, Wx, Wy))
            & rng.randint(0, 32, size=(B, Wx, Wy))).astype(np.int32)
    secb[rng.rand(B, Wx, Wy) > density] = 0
    sx = rng.uniform(-1, 1, size=(B, 1, 1))
    sy = rng.uniform(-1, 1, size=(B, 1, 1))
    ii, jj = np.meshgrid(np.arange(Wx), np.arange(Wy), indexing="ij")
    zb = np.floor(sx * ii + sy * jj + rng.uniform(0, 1, size=(B, 1, 1)))
    zb = zb.astype(np.int32) - 2
    seed_w = np.zeros_like(secb)
    for b in range(B):
        i, j = rng.randint(Wx), rng.randint(Wy)
        seed_w[b, i, j] = secb[b, i, j] | (1 << 2)
    seed_w &= secb
    return seed_w, secb, zb


def test_bit_helpers_bit_equal():
    rng = np.random.RandomState(1)
    bits = rng.randint(0, 32, size=(4, 9, 7)).astype(np.int32)
    delta = rng.randint(-40, 40, size=(4, 9, 7)).astype(np.int32)
    tb, td = torch.from_numpy(bits), torch.from_numpy(delta)
    want = np.asarray(jxsslab._var_shift(jnp.asarray(bits, jnp.uint32),
                                         jnp.asarray(delta)))
    got = txsslab._var_shift(tb, td).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jxsslab._kdilate(jnp.asarray(bits, jnp.uint32)))
    np.testing.assert_array_equal(
        txsslab._kdilate(tb).numpy().astype(np.uint32), want)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            want = np.stack([np.asarray(jxsslab._shift2(
                jnp.asarray(b), dx, dy, jnp.int32(0))) for b in bits])
            np.testing.assert_array_equal(
                txsslab._shift2(tb, dx, dy, 0).numpy(), want)


def _jax_dilate(seed, secb, zb, rounds):
    """The dilation loop of kimimaro_tpu.ops.xsbatch._finish_section for
    one lane, built from the JAX package's helpers."""
    def body(carry, _):
        r, _ = carry
        nxt = r | jxsslab._kdilate(r)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                rs = jxsslab._shift2(r, dx, dy, jnp.uint32(0))
                zbs = jxsslab._shift2(zb, dx, dy, jnp.int32(0))
                nxt = nxt | jxsslab._kdilate(jxsslab._var_shift(rs, zbs - zb))
        nxt = nxt & secb
        return (nxt, jnp.any(nxt != r)), None

    (kept, changed), _ = jax.lax.scan(body, (seed, jnp.bool_(True)), None,
                                      length=int(rounds) + 1)
    return kept, changed


@pytest.mark.parametrize("method,rounds", [("sweep", 0), ("sweep", 6),
                                           ("dilate", 2), ("dilate", 36)])
def test_section_flood_plain_bit_equal(method, rounds):
    seed, secb, zb = _random_windows(3 + rounds)
    if method == "sweep":
        fn = jax.vmap(lambda s, b, z: jxsslab._sweep_rounds(s, b, z, rounds))
    else:
        fn = jax.vmap(lambda s, b, z: _jax_dilate(s, b, z, rounds))
    wk, wc = fn(jnp.asarray(seed, jnp.uint32), jnp.asarray(secb, jnp.uint32),
                jnp.asarray(zb))
    kept, changed, run = txsslab.section_flood(
        torch.from_numpy(seed), torch.from_numpy(secb), torch.from_numpy(zb),
        rounds, method)
    np.testing.assert_array_equal(kept.numpy().astype(np.uint32),
                                  np.asarray(wk))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(wc))
    assert (run.numpy() <= rounds + 1).all()
    if rounds <= 2:
        assert changed.any()  # some lane never converges
    else:
        assert not changed.all()


# the dilation's windows at the edges of X1's lane-warp form: one cell, a
# row narrower than a warp, a warp's width, one row past it (registers of
# 64 cells or two columns a thread), the per-label rung's 64 x 64; rounds
# 0 (one round run), 1, the dense rung's 36 and the per-label rung's 96
X1_DILATE_EDGES = [(w, r) for w in ((1, 1), (5, 31), (32, 32), (33, 17),
                                    (64, 64)) for r in (0, 1, 36, 96)]


@pytest.mark.parametrize("window,rounds", X1_DILATE_EDGES)
def test_section_flood_dilate_edges_match_jax(window, rounds):
    Wx, Wy = window
    seed, secb, zb = _random_windows(Wx * 97 + Wy + rounds, B=3, Wx=Wx,
                                     Wy=Wy)
    fn = jax.vmap(lambda s, b, z: _jax_dilate(s, b, z, rounds))
    wk, wc = fn(jnp.asarray(seed, jnp.uint32), jnp.asarray(secb, jnp.uint32),
                jnp.asarray(zb))
    kept, changed, run = txsslab.section_flood(
        torch.from_numpy(seed), torch.from_numpy(secb), torch.from_numpy(zb),
        rounds, "dilate")
    np.testing.assert_array_equal(kept.numpy().astype(np.uint32),
                                  np.asarray(wk))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(wc))
    assert ((run.numpy() >= 1) & (run.numpy() <= rounds + 1)).all()


def test_fetch_plain_matches_xsfetch_kernel(monkeypatch):
    """The plain B6 against the Pallas kernel in interpret mode on windows
    it accepts (128-aligned y starts), on the bits the kernel defines."""
    monkeypatch.setattr(jxsfetch, "INTERPRET", True)
    tx, tz, ty = 32, 160, 256
    rng = np.random.RandomState(0)
    # labels 0-6 in 4-voxel blocks
    volk = np.kron(rng.randint(0, 7, size=(tx // 4, tz // 4, ty // 4)),
                   np.ones((4, 4, 4), np.int32)).astype(np.int32)
    Wx, Wyf, B = 16, 256, 4
    assert jxsfetch.usable((tx, tz, ty), Wx, Wyf)
    wx0 = np.array([0, 16, 7, 3], np.int32)
    wy0 = np.zeros(B, np.int32)
    labels = rng.randint(1, 7, size=B).astype(np.int32)
    ii, jj = np.meshgrid(np.arange(Wx), np.arange(Wyf), indexing="ij")
    zb = np.stack([np.floor(z0 + sx * ii + sy * jj).astype(np.int32) - 2
                   for z0, sx, sy in zip((-3, 40, 100, 158),
                                         rng.uniform(-1, 1, B),
                                         rng.uniform(-0.3, 0.3, B))])
    want = np.asarray(jxsfetch.fetch_secb(
        jnp.asarray(volk), jnp.asarray(zb), jnp.asarray(wx0),
        jnp.asarray(wy0), jnp.asarray(labels), (tx, tz, ty), Wx, Wyf))
    got = txsfetch.fetch_secb(
        torch.from_numpy(np.ascontiguousarray(volk.transpose(0, 2, 1))),
        torch.from_numpy(zb), torch.from_numpy(wx0), torch.from_numpy(wy0),
        torch.from_numpy(labels)).numpy()
    for k in range(K):
        valid = (zb + k >= 0) & (zb + k < tz)
        gb, wb = (got >> k) & 1, (want >> k) & 1
        np.testing.assert_array_equal(gb[valid], wb[valid])
        assert not gb[~valid].any()
    assert got.any()


def _fetch_windows(tz, seed=0):
    """A (24, 40, tz) label volume in 2-voxel blocks, and windows that
    start anywhere (volume faces included) with zb from below 0 to beyond
    tz."""
    rng = np.random.RandomState(seed)
    tx, ty = 24, 40
    vol = np.kron(rng.randint(0, 5, size=(tx // 2, ty // 2, tz // 2 + 1)),
                  np.ones((2, 2, 2), np.int32))[:, :, :tz].astype(np.int32)
    B, Wx, Wy = 5, 9, 13
    wx0 = np.array([0, tx - Wx, 3, 7, 15], np.int32)
    wy0 = np.array([ty - Wy, 0, 11, 5, 27], np.int32)
    labels = rng.randint(0, 6, size=B).astype(np.int32)
    zb = rng.randint(-8, tz + 4, size=(B, Wx, Wy)).astype(np.int32)
    return vol, zb, wx0, wy0, labels


def _fetch_vector_path(vol, zb, wx0, wy0, labels):
    """Kernel B6's vector path emulated in numpy: per cell, the aligned
    8-word span base .. base + 7 (base = zb & ~3) in two halves, each
    read only where it lies inside [0, tz), its match bits shifted by
    zb & 3."""
    tz = vol.shape[2]
    B, Wx, Wy = zb.shape
    gx = wx0[:, None, None] + np.arange(Wx)[None, :, None]
    gy = wy0[:, None, None] + np.arange(Wy)[None, None, :]
    base = zb & ~3
    span = np.zeros(zb.shape, np.int64)
    for half in (0, 1):
        start = base + 4 * half
        inside = (start >= 0) & (start < tz)
        z = np.clip(start, 0, tz - 4)[..., None] + np.arange(4)
        vals = vol[gx[..., None], gy[..., None], z]
        bits = ((vals == labels[:, None, None, None]) << np.arange(4)).sum(-1)
        span |= np.where(inside, bits, 0) << (4 * half)
    return ((span >> (zb & 3)) & 31).astype(np.int32)


@pytest.mark.parametrize("tz", (160, 161, 162, 163))
def test_fetch_plain_on_any_depth(tz):
    """The plain B6 on volumes of every tz % 4 (kernel B6 reads two
    16-byte loads a cell only where tz % 4 == 0 and the base is aligned,
    and K 4-byte loads elsewhere): equal to the JAX package's element
    gather with its z-validity mask (`slab_sections_volume`), and where
    the vector path applies, to that path emulated; `fetch_plan` picks
    the vector path there and not on a view at a 4-byte offset."""
    vol, zb, wx0, wy0, labels = _fetch_windows(tz)
    tx, ty, _ = vol.shape
    B, Wx, Wy = zb.shape

    def gather(vol_flat, zb, wx0, wy0, labels):
        gx = wx0[:, None, None] + jnp.arange(Wx)[None, :, None]
        gy = wy0[:, None, None] + jnp.arange(Wy)[None, None, :]
        zidx = zb[..., None] + jnp.arange(K, dtype=jnp.int32)
        zvalid = (zidx >= 0) & (zidx < tz)
        flat = (gx[..., None] * (ty * tz) + gy[..., None] * tz
                + jnp.clip(zidx, 0, tz - 1))
        fg = (jnp.take(vol_flat, flat) == labels[:, None, None, None]) \
            & zvalid
        return jnp.sum(fg.astype(jnp.int32) << jnp.arange(K), axis=-1)

    want = np.asarray(jax.jit(gather)(
        jnp.asarray(vol.reshape(-1)), jnp.asarray(zb), jnp.asarray(wx0),
        jnp.asarray(wy0), jnp.asarray(labels)))
    tvol = torch.from_numpy(vol)
    got = txsfetch.fetch_secb(tvol, torch.from_numpy(zb),
                              torch.from_numpy(wx0), torch.from_numpy(wy0),
                              torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and (zb < 0).any() and (zb + K > tz).any()
    plan = txsfetch.fetch_plan(tvol, torch.from_numpy(zb))
    assert plan["vector"] == (tz % 4 == 0 and tvol.data_ptr() % 16 == 0)
    if tz % 4 == 0:
        np.testing.assert_array_equal(
            _fetch_vector_path(vol, zb, wx0, wy0, labels), want)
    buf = torch.zeros(vol.size + 1, dtype=torch.int32)
    shifted = buf[1:].view(vol.shape)
    shifted.copy_(tvol)
    assert shifted.data_ptr() % 16 != 0
    assert not txsfetch.fetch_plan(shifted, torch.from_numpy(zb))["vector"]


def _multi_label_volume():
    """Three disjoint tubes of different orientation and a small blob."""
    labels = np.zeros((48, 40, 36), dtype=np.uint32)
    labels[4:44, 6:10, 6:10] = 7
    labels[10:14, 4:36, 20:24] = 900
    labels[30:34, 28:32, 2:34] = 31
    labels[38:46, 20:28, 22:30] = 4242
    return labels


def _blob_volume(seed=11, shape=(30, 26, 22)):
    """Two labels with carved holes, so sections are not convex."""
    rng = np.random.RandomState(seed)
    labels = np.zeros(shape, dtype=np.uint32)
    labels[3:27, 4:22, 3:19] = 5
    labels[3:27, 4:12, 3:10] = 6
    labels[rng.rand(*shape) < 0.15] = 0
    return labels


def _queries(labels, n, seed, ids=(5, 6)):
    rng = np.random.RandomState(seed)
    fg = np.argwhere(np.isin(labels, ids))
    verts = fg[rng.choice(len(fg), n, replace=False)].astype(np.int32)
    return verts, _random_normals(rng, n), labels[tuple(verts.T)]


@pytest.mark.parametrize("rung", range(4))
def test_slab_sections_volume_matches_jax(rung):
    """Each rung's window, rounds and flood on one dominant-axis group
    (the three groups' permutations across the four rungs)."""
    labels = _blob_volume()
    verts, normals, qlab = _queries(labels, 16, seed=rung)
    anis = (16.0, 16.0, 40.0)
    W, rounds, method = txsbatch._RUNGS[rung]
    d = rung % 3
    normals[:, d] = np.where(normals[:, d] < 0, -4.0, 4.0)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    assert (np.argmax(np.abs(normals) * np.float32(anis), axis=1) == d).all()
    perm = txsbatch._PERMS[d]
    volp = np.ascontiguousarray(labels.transpose(perm)).view(np.int32)
    dims = volp.shape
    anis_p = tuple(anis[p] for p in perm)
    v, m = verts[:, perm], normals[:, perm]
    ql = qlab.astype(np.int32)
    wa, wc, wv = jxsbatch.slab_sections_volume(
        jnp.asarray(volp.reshape(-1)), jnp.asarray(ql), jnp.asarray(v),
        jnp.asarray(m), dims, (dims[1] * dims[2], dims[2], 1), anis_p,
        W=W, rounds=rounds, method=method)
    ga, gc, gv = txsbatch.slab_sections_volume(
        torch.from_numpy(volp), torch.from_numpy(ql),
        torch.from_numpy(v.copy()), torch.from_numpy(m.copy()), anis_p,
        W=W, rounds=rounds, method=method)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert (ga.numpy() > 0).all()


def _counters(prof, prefix):
    return {k: v for k, v in prof.get_stats()["counters"].items()
            if k.startswith(prefix) and not k.endswith("_ms")}


def _run_counted(prof, fn):
    prof.reset_stats()
    prof.collect(True)
    try:
        return fn()
    finally:
        prof.collect(False)


def test_cross_section_areas_volume_matches_jax():
    labels = _blob_volume()
    verts, normals, qlab = _queries(labels, 40, seed=9)
    normals[:2] = 0.0  # degenerate: converged zeros, no dispatch
    radii = np.random.RandomState(2).uniform(-1, 400, 40).astype(np.float32)
    anis = (16.0, 16.0, 40.0)
    wa, wc = _run_counted(jprof, lambda: jxsbatch.cross_section_areas_volume(
        labels, verts, normals, qlab, anis, radii=radii))
    want_counts = _counters(jprof, "xsb_")
    ga, gc = _run_counted(tprof, lambda: txsbatch.cross_section_areas_volume(
        labels, verts, normals, qlab, anis, radii=radii, device="cpu"))
    assert _counters(tprof, "xsb_") == want_counts
    assert want_counts["xsb_rung0_queries"] > 0
    np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(gc, wc)
    assert (ga[:2] == 0).all() and (ga[2:] > 0).any()


def test_cross_section_areas_volume_absent_label_and_zero_queries():
    labels = np.ones((8, 8, 8), dtype=np.uint32)
    areas, contacts = txsbatch.cross_section_areas_volume(
        labels, np.zeros((2, 3), np.int32),
        np.tile([[1.0, 0, 0]], (2, 1)).astype(np.float32),
        np.array([99, 99]), (1, 1, 1), device="cpu")
    np.testing.assert_array_equal(areas, 0.0)
    np.testing.assert_array_equal(contacts, 0)
    areas, contacts = txsbatch.cross_section_areas_volume(
        labels, np.zeros((0, 3), np.int32), np.zeros((0, 3), np.float32),
        np.zeros(0), (1, 1, 1), device="cpu")
    assert areas.shape == (0,) and contacts.shape == (0,)


def test_per_label_cross_section_areas_matches_jax():
    """The per-label driver (slab rungs, then the dense rung) on one
    binary crop, random normals and a few zero normals (the dense rungs
    only)."""
    binimg = _blob_volume(seed=4, shape=(22, 19, 17)) == 5
    rng = np.random.RandomState(5)
    fgv = np.argwhere(binimg)
    verts = fgv[rng.choice(len(fgv), 20, replace=False)]
    normals = _random_normals(rng, 20)
    normals[:3] = 0.0
    normals[3] = (1, 0, 0)
    anis = (4.0, 1.0, 11.0)
    wa, wc = jxsarea.cross_section_areas(binimg, verts, normals, anis)
    ga, gc = txsarea.cross_section_areas(binimg, verts, normals, anis)
    np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(gc, wc)


def test_cross_section_image_matches_jax():
    """The per-voxel section image (visualize_section_planes): per-cell
    areas on the 26-connected section, exact."""
    binimg = _blob_volume(seed=4, shape=(22, 19, 17)) == 5
    vert = np.argwhere(binimg)[40]
    normal = np.float32([0.3, -0.5, 0.81])
    normal /= np.linalg.norm(normal)
    want = jxsarea.cross_section_image(binimg, vert, normal, (4.0, 1.0, 11.0))
    got = txsarea.cross_section_image(binimg, vert, normal, (4.0, 1.0, 11.0))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 10


def _to_torch_skel(s):
    t = TSkeleton(s.vertices.copy(), s.edges.copy(), radii=s.radii.copy(),
                  segid=s.id)
    t.space = s.space
    return t


def _assert_same_xs(jskels, tskels):
    assert set(jskels) == set(tskels)
    for k in jskels:
        ja = jskels[k].cross_sectional_area
        np.testing.assert_allclose(tskels[k].cross_sectional_area, ja,
                                   rtol=RTOL, atol=0, err_msg=f"label {k}")
        np.testing.assert_array_equal(
            tskels[k].cross_sectional_area_contacts,
            jskels[k].cross_sectional_area_contacts, err_msg=f"label {k}")
        assert ([p["id"] for p in tskels[k].extra_attributes]
                == [p["id"] for p in jskels[k].extra_attributes])


_MULTI_SKELS = {}


def _multi_skels():
    if not _MULTI_SKELS:
        labels = _multi_label_volume()
        _MULTI_SKELS.update(kimimaro_tpu.skeletonize(
            labels, teasar_params={"scale": 1.5, "const": 2},
            dust_threshold=10, fix_borders=False))
    return _MULTI_SKELS


@pytest.mark.parametrize("kw", [
    {"step": 1},
    {"step": 3, "smoothing_window": 3},
    {"fill_holes": True},
    {"multipass": True},
    {"repair_contacts": True},
], ids=["step1", "step3", "fill_holes", "multipass", "repair_contacts"])
def test_cross_sectional_area_matches_jax(kw):
    labels = _multi_label_volume()
    skels = _multi_skels()
    assert len(skels) >= 3
    jsk = {k: s.clone() for k, s in skels.items()}
    tsk = {k: _to_torch_skel(s) for k, s in skels.items()}
    if kw.get("multipass") or kw.get("repair_contacts"):
        # a first pass leaves areas and contacts for the second to reuse
        kimimaro_tpu.cross_sectional_area(labels, jsk, step=4)
        kimimaro_tpu_torch.cross_sectional_area(labels, tsk, step=4,
                                                device="cpu")
        _assert_same_xs(jsk, tsk)
    kimimaro_tpu.cross_sectional_area(labels, jsk, **kw)
    kimimaro_tpu_torch.cross_sectional_area(labels, tsk, device="cpu", **kw)
    _assert_same_xs(jsk, tsk)


def test_cross_sectional_area_bool_bar_and_single():
    labels = np.ones((40, 3, 3), dtype=bool)
    vertices = np.array([[x, 1, 1] for x in range(labels.shape[0])])
    edges = np.array([[x, x + 1] for x in range(labels.shape[0] - 1)])
    skel = TSkeleton(vertices, edges, segid=1)
    out = kimimaro_tpu_torch.cross_sectional_area(
        labels, skel.clone(), smoothing_window=5, device="cpu")
    assert np.all(out.cross_sectional_area == 9)
    contacts = out.cross_sectional_area_contacts
    assert contacts[0] & 0b01 and contacts[-1] & 0b10
    assert np.all(contacts & 0b111100 == 0b111100)
    single = kimimaro_tpu_torch.cross_sectional_area_single(
        labels, skel.clone(), smoothing_window=5, device="cpu")
    np.testing.assert_array_equal(single.cross_sectional_area,
                                  out.cross_sectional_area)


def test_cross_sectional_area_single_matches_jax():
    """The per-label path on a crop with a bounding box offset."""
    from kimimaro_tpu.utils.bbox import Bbox as JBbox
    from kimimaro_tpu_torch.utils.bbox import Bbox as TBbox

    labels = _multi_label_volume()
    skel = _multi_skels()[900]
    roi = ([8, 2, 18], [16, 38, 26])
    binimg = labels[8:16, 2:38, 18:26] == 900
    want = kimimaro_tpu.cross_sectional_area_single(
        binimg, skel.clone(), JBbox(*roi), smoothing_window=3)
    got = kimimaro_tpu_torch.cross_sectional_area_single(
        binimg, _to_torch_skel(skel), TBbox(*roi), smoothing_window=3,
        device="cpu")
    _assert_same_xs({1: want}, {1: got})


def test_cross_sectional_area_uint64_big_ids():
    """Ids above 2^32 cannot ride the int32 equality test: both packages
    take the per-label path, through the host renumbering."""
    labels = np.zeros((20, 6, 6), dtype=np.uint64)
    labels[2:18, 1:5, 1:5] = 2 ** 40
    vertices = np.array([[x, 2, 2] for x in range(2, 18)], np.float32)
    edges = np.array([[i, i + 1] for i in range(len(vertices) - 1)])
    jsk = {2 ** 40: kimimaro_tpu.Skeleton(vertices, edges, segid=2 ** 40)}
    tsk = {2 ** 40: TSkeleton(vertices, edges, segid=2 ** 40)}
    kimimaro_tpu.cross_sectional_area(labels, jsk)
    kimimaro_tpu_torch.cross_sectional_area(labels, tsk, device="cpu")
    _assert_same_xs(jsk, tsk)
    assert np.any(tsk[2 ** 40].cross_sectional_area > 0)


def test_cross_sectional_area_uint32_ids_above_2_31():
    """uint32 ids >= 2^31 ride the equality test by bit pattern."""
    labels = _multi_label_volume()
    big = labels.copy()
    big[labels == 900] = 2 ** 31 + 5
    skels = {k: s.clone() for k, s in _multi_skels().items()}
    skels[2 ** 31 + 5] = skels.pop(900)
    skels[2 ** 31 + 5].id = 2 ** 31 + 5
    jsk = {k: s.clone() for k, s in skels.items()}
    tsk = {k: _to_torch_skel(s) for k, s in skels.items()}
    kimimaro_tpu.cross_sectional_area(big, jsk)
    kimimaro_tpu_torch.cross_sectional_area(big, tsk, device="cpu")
    _assert_same_xs(jsk, tsk)
    assert (tsk[2 ** 31 + 5].cross_sectional_area > 0).all()


def test_cross_sectional_area_absent_label_and_no_vertices():
    labels = _multi_label_volume()
    vertices = np.array([[20, 20, 20], [21, 20, 20]], dtype=np.float32)
    absent = TSkeleton(vertices, np.array([[0, 1]]), segid=77)
    empty = TSkeleton(np.zeros((0, 3), np.float32), np.zeros((0, 2), int),
                      segid=7)
    out = kimimaro_tpu_torch.cross_sectional_area(
        labels, {77: absent, 7: empty}, device="cpu")
    np.testing.assert_array_equal(out[77].cross_sectional_area, 0.0)
    assert out[7].cross_sectional_area.shape == (0,)
    for fill in (False, True):
        out = kimimaro_tpu_torch.cross_sectional_area(
            labels, {77: absent.clone()}, fill_holes=fill, device="cpu")
        assert out[77].cross_sectional_area.shape == (2,)


def test_skeletonize_then_cross_sections_matches_jax():
    """End to end: the port skeletonizes the multi-label volume (the JAX
    package's skeletons of it are the fixture's) and each package sections
    its own skeletons."""
    labels = _multi_label_volume()
    jsk = {k: s.clone() for k, s in _multi_skels().items()}
    tsk = kimimaro_tpu_torch.skeletonize(
        labels, teasar_params={"scale": 1.5, "const": 2}, dust_threshold=10,
        fix_borders=False, device="cpu")
    kimimaro_tpu.cross_sectional_area(labels, jsk, smoothing_window=3)
    kimimaro_tpu_torch.cross_sectional_area(labels, tsk, smoothing_window=3,
                                            device="cpu")
    _assert_same_xs(jsk, tsk)


def test_moving_average_matches_jax():
    from kimimaro_tpu.utility import moving_average as jma

    a = np.random.RandomState(0).randn(17, 3)
    for n in (1, 2, 5):
        np.testing.assert_array_equal(kimimaro_tpu_torch.moving_average(a, n),
                                      jma(a, n))


def test_cross_sectional_area_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        kimimaro_tpu_torch.cross_sectional_area(
            _multi_label_volume(), {}, device="cuda")

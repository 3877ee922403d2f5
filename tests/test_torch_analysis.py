"""The port's analysis extras against the JAX package on the CPU, bit for
bit: voronoi_feature_field (kernel V1's plain version), oversegment,
point_to_point and connect_points, synapses_to_targets (and the targets
through skeletonize), renumber_cc and invalidation_cube.

Inputs are made from seeds with numpy; each package gets the same arrays
and skeletons with the same vertices and edges. The JAX side runs on the
CPU as its own tests run it."""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the JAX package's tests run it)
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu import intake as jintake
from kimimaro_tpu import trace as jtrace
from kimimaro_tpu.ops import ccl as jccl
from kimimaro_tpu.ops import geodesic as jgeo
from kimimaro_tpu.skeleton import Skeleton as JSkeleton

# Loading the submodule kimimaro_tpu.oversegment rebinds the package's
# attribute `oversegment` from its lazy wrapper to the submodule (ROADMAP
# Queue C 10); the wrapper goes back, for the other test files that this
# process imports and runs.
_jax_wrapper = kimimaro_tpu.oversegment
from kimimaro_tpu.oversegment import oversegment as joversegment  # noqa: E402
kimimaro_tpu.oversegment = _jax_wrapper
from kimimaro_tpu_torch import intake as tintake
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.ops import ccl as tccl
from kimimaro_tpu_torch.ops import geodesic as tgeo
from kimimaro_tpu_torch.utils import profiling

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


def test_exports_match_the_jax_package():
    assert set(kimimaro_tpu_torch.__all__) == set(kimimaro_tpu.__all__)
    for name in kimimaro_tpu_torch.__all__:
        assert callable(getattr(kimimaro_tpu_torch, name)) or name == \
            "DEFAULT_TEASAR_PARAMS"
    from kimimaro_tpu import ops as jops
    from kimimaro_tpu_torch import ops as tops

    assert set(tops.__all__) == set(jops.__all__)
    for name in ("renumber_cc", "invalidation_cube", "voronoi_feature_field"):
        assert callable(getattr(tops, name))


# --------------------------------------------------------------------------- #
# voronoi_feature_field

# (shape, anisotropy, seed): an n = 1 axis in two of them
VORONOI = {
    "iso": ((14, 11, 9), (1.0, 1.0, 1.0), 0),
    "aniso": ((9, 16, 1), ANIS, 1),
    "skew": ((1, 13, 12), (3.7, 1.3, 2.9), 2),
}


def _voronoi_case(name):
    """A mask with a quarter of its voxels cut, a walled-off box no seed
    reaches, seeds with two repeated voxels (the later wins), one seed
    outside the mask and one out of the volume (dropped), and a negative
    coordinate (counted from the end)."""
    shape, anis, seed = VORONOI[name]
    rng = np.random.RandomState(seed)
    ok = rng.rand(*shape) < 0.75
    sl = tuple(slice(max(0, s - 4), s) for s in shape)
    ok[sl] = True
    wall = tuple(slice(max(0, s - 5), s) for s in shape)
    inner = tuple(slice(max(0, s - 4), s) for s in shape)
    ok[wall] = False
    ok[inner] = True  # a box of the far corner the seeds below never reach
    far = np.array([s.start for s in inner])
    pts = np.argwhere(ok)
    pts = pts[~np.all(pts >= far, axis=1)]
    seeds = pts[rng.choice(len(pts), size=min(7, len(pts)), replace=False)]
    off = np.argwhere(~ok)
    extra = [seeds[1], seeds[3], off[len(off) // 2], -np.ones(3, np.int64),
             np.array(shape) + 2]
    return ok, np.concatenate([seeds, np.stack(extra)]), anis


@pytest.mark.parametrize("case", sorted(VORONOI))
def test_voronoi_feature_field_matches_jax(case):
    ok, seeds, anis = _voronoi_case(case)
    jd, jf = jgeo.voronoi_feature_field(ok, seeds, anis)
    td, tf = tgeo.voronoi_feature_field(torch.from_numpy(ok), seeds, anis)
    jd, jf = np.asarray(jd), np.asarray(jf)
    assert np.isfinite(jd).sum() > 1 and (jf == 0).any()
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tf.numpy(), jf)


# V1 at its edge shapes: sweeps of 1, 2, 7 and 9 planes, planes of one,
# three and 17 rows
V1_EDGES = [(n, H) for n in (1, 2, 7, 9) for H in (1, 3, 17)]


@pytest.mark.parametrize("n,H", V1_EDGES)
def test_voronoi_feature_field_edges_match_jax(n, H):
    """voronoi_feature_field on (n, H, 6) masks, once with isotropic steps
    and integer-spaced seeds (so that steps tie) and once anisotropic,
    against the JAX package's."""
    rng = np.random.RandomState(100 * n + H)
    ok = rng.rand(n, H, 6) < 0.8
    ok[0, 0, 0] = ok[-1, -1, -1] = True
    pts = np.argwhere(ok)
    seeds = pts[rng.choice(len(pts), size=min(4, len(pts)), replace=False)]
    for anis in ((1.0, 1.0, 1.0), (3.7, 1.3, 2.9)):
        jd, jf = jgeo.voronoi_feature_field(ok, seeds, anis)
        td, tf = tgeo.voronoi_feature_field(torch.from_numpy(ok), seeds,
                                            anis, device="cpu")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_voronoi_ties_take_the_first_offset():
    """Two seeds at equal isotropic distance from a whole plane: every tie
    goes to the first of the nine offsets, as JAX's strict compare
    decides."""
    ok = np.ones((5, 6, 7), dtype=bool)
    seeds = np.array([[0, 2, 3], [0, 3, 3], [4, 0, 0], [4, 0, 0]])
    jd, jf = jgeo.voronoi_feature_field(ok, seeds)
    td, tf = tgeo.voronoi_feature_field(torch.from_numpy(ok), seeds)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert set(np.unique(np.asarray(jf))) == {1, 2, 4}


def test_voronoi_stops_at_max_rounds_like_jax():
    """A winding corridor that needs many rounds, cut at one stage: the
    port returns what JAX's whole stage gives, without raising."""
    ok = np.zeros((2, 48, 8), dtype=bool)
    for i, y in enumerate(range(0, 48, 2)):
        ok[:, y, :] = True
        ok[:, y + 1, (7 if i % 2 == 0 else 0)] = True
    seeds = np.array([[1, 0, 0]])
    jd, jf = jgeo.voronoi_feature_field(ok, seeds, max_rounds=3)
    td, tf = tgeo.voronoi_feature_field(torch.from_numpy(ok), seeds,
                                        max_rounds=3)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    full, _ = tgeo.voronoi_feature_field(torch.from_numpy(ok), seeds)
    assert np.isfinite(full.numpy()).sum() > np.isfinite(td.numpy()).sum()


def test_voronoi_sweep_plain_flags_changes():
    """The plain sweep's change flag (the kernel's contract): set by a
    sweep that lowers a distance, left alone by one that changes nothing."""
    from kimimaro_tpu_torch.ops.voronoi import voronoi_sweep

    d = torch.full((4, 3, 3), float("inf"))
    d[0, 1, 1] = 0.0
    f = torch.zeros((4, 3, 3), dtype=torch.int32)
    f[0, 1, 1] = 5
    ok = torch.ones((4, 3, 3), dtype=torch.bool)
    costs = tgeo.plane_costs(0, False, (1.0, 1.0, 1.0))
    changed = torch.zeros(1, dtype=torch.int32)
    d1, f1 = voronoi_sweep(d, f, ok, costs, False, changed)
    assert int(changed) == 1 and bool((f1[1:] == 5).all())
    changed.zero_()
    voronoi_sweep(d1, f1, ok, costs, False, changed)
    assert int(changed) == 0


def _corridor():
    """A winding corridor of 2 x 48 x 8 that needs many rounds from one
    seed."""
    ok = np.zeros((2, 48, 8), dtype=bool)
    for i, y in enumerate(range(0, 48, 2)):
        ok[:, y, :] = True
        ok[:, y + 1, (7 if i % 2 == 0 else 0)] = True
    return ok, np.array([[1, 0, 0]])


def _batch_cases():
    """One batch of crops of different shapes: `_voronoi_case`'s masks
    (n = 1 axes, repeated seeds, a seed outside the mask, an unreachable
    box, a negative coordinate), the tie case, the corridor, a lane with
    no seed in the volume, and shapes on both sides of a bucket side
    (16, 17)."""
    cases = [_voronoi_case(name)[:2] for name in sorted(VORONOI)]
    cases.append((np.ones((5, 6, 7), dtype=bool),
                  np.array([[0, 2, 3], [0, 3, 3], [4, 0, 0], [4, 0, 0]])))
    cases.append(_corridor())
    cases.append((np.ones((3, 4, 5), dtype=bool), np.array([[9, 9, 9]])))
    rng = np.random.RandomState(8)
    for shape in ((16, 3, 17), (17, 16, 2)):
        ok = rng.rand(*shape) < 0.7
        seeds = np.argwhere(ok)[rng.choice(int(ok.sum()), 3, replace=False)]
        cases.append((ok, seeds))
    return cases


def test_voronoi_feature_field_batched_matches_jax():
    """One batch of crops of different shapes, crop by crop equal to the
    JAX package's voronoi_feature_field; each lane is smaller than its
    bucket in some side but the (16, 16) sides."""
    cases = _batch_cases()
    anis = (1.0, 2.0, 1.5)
    got = tgeo.voronoi_feature_field_batched(
        [ok for ok, _ in cases], [s for _, s in cases], anis, device="cpu")
    assert len(got) == len(cases)
    for (ok, seeds), (td, tf) in zip(cases, got):
        jd, jf = jgeo.voronoi_feature_field(ok, seeds, anis)
        assert tuple(td.shape) == ok.shape
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("anis", ((1.0, 1.0, 1.0), (3.7, 1.3, 2.9)))
def test_voronoi_batched_equals_single_calls(anis):
    """The batch is bit-equal to the port's single calls, masks given as
    arrays or tensors, with the lane-rounds and the padding counted."""
    cases = _batch_cases()
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = tgeo.voronoi_feature_field_batched(
            [torch.from_numpy(ok) for ok, _ in cases],
            [s for _, s in cases], anis)
        batched = profiling.get_stats()["counters"]
        profiling.reset_stats()
        want = [tgeo.voronoi_feature_field(ok, s, anis, device="cpu")
                for ok, s in cases]
        single = profiling.get_stats()["counters"]
    finally:
        profiling.collect(False)
    for (wd, wf), (gd, gf) in zip(want, got):
        assert torch.equal(gd, wd) and torch.equal(gf, wf)
    assert batched["voronoi_rounds"] == single["voronoi_rounds"]
    assert batched["voronoi_batches"] == 1
    real = sum(ok.size for ok, _ in cases)
    padded = sum(int(np.prod(tgeo.voronoi_bucket(ok.shape)))
                 for ok, _ in cases)
    assert batched["voronoi_voxels"] == real
    assert batched["voronoi_padded_voxels"] == padded > real


def test_voronoi_batched_lanes_leave_active_after_a_fixpoint():
    """A lane that converges in its first round (no seed in the volume)
    beside one that needs many (the corridor): the first is swept in one
    round only, and the results equal the single calls."""
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    (still_ok, still_seeds), (cor_ok, cor_seeds) = (
        (np.ones((3, 4, 5), dtype=bool), np.array([[9, 9, 9]])), _corridor())
    calls = []
    inner = tvoronoi._voronoi_sweep_lanes_plain

    def spy(d, f, ok, lanes, costs9, descending, changed, active=None):
        calls.append(active.clone())
        return inner(d, f, ok, lanes, costs9, descending, changed, active)

    tvoronoi._voronoi_sweep_lanes_plain = spy
    try:
        got = tgeo.voronoi_feature_field_batched(
            [still_ok, cor_ok], [still_seeds, cor_seeds], device="cpu")
    finally:
        tvoronoi._voronoi_sweep_lanes_plain = inner
    rounds = len(calls) // 6
    assert rounds > 3 and len(calls) == 6 * rounds
    assert all(bool(a[0]) == (k < 6) for k, a in enumerate(calls))
    assert all(bool(a[1]) for a in calls)
    for (ok, seeds), (gd, gf) in zip(((still_ok, still_seeds),
                                      (cor_ok, cor_seeds)), got):
        wd, wf = tgeo.voronoi_feature_field(ok, seeds, device="cpu")
        assert torch.equal(gd, wd) and torch.equal(gf, wf)


@pytest.mark.parametrize("max_rounds", (0, 3, 9))
def test_voronoi_batched_cap_stops_where_jax_stops(max_rounds):
    """The cap on rounds is JAX's stages of seven for every lane: the
    corridor is cut where JAX cuts it, a lane that converges early is
    not."""
    cases = [_corridor(), _voronoi_case("iso")[:2]]
    got = tgeo.voronoi_feature_field_batched(
        [ok for ok, _ in cases], [s for _, s in cases],
        max_rounds=max_rounds, device="cpu")
    for (ok, seeds), (td, tf) in zip(cases, got):
        jd, jf = jgeo.voronoi_feature_field(ok, seeds, max_rounds=max_rounds)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    full, _ = tgeo.voronoi_feature_field(*cases[0], device="cpu")
    # seven rounds cut the corridor; fourteen reach its fixpoint
    assert torch.equal(full, got[0][0]) == (max_rounds > 7)


def test_voronoi_sweep_batched_plain_is_each_lanes_sweep():
    """The plain batched sweep: each active lane's extent swept as
    `_voronoi_sweep_plain` sweeps it, in place, with its own flag; voxels
    outside the extents and inactive lanes untouched."""
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    rng = np.random.RandomState(2)
    B, N, H, W = 4, 6, 5, 7
    ext = np.array([[6, 5, 7], [3, 2, 4], [1, 5, 1], [4, 4, 6]])
    d = torch.from_numpy(np.where(rng.rand(B, N, H, W) < 0.3, np.floor(
        rng.rand(B, N, H, W) * 4), np.inf).astype(np.float32))
    f = torch.from_numpy(rng.randint(1, 50, size=(B, N, H, W)).astype(
        np.int32))
    ok = torch.from_numpy(rng.rand(B, N, H, W) < 0.8)
    active = torch.tensor([True, True, True, False])
    costs = tgeo.plane_costs(0, True, (1.0, 1.0, 1.0))
    gd, gf = d.clone(), f.clone()
    changed = torch.zeros(B, dtype=torch.int32)
    tvoronoi.voronoi_sweep_batched(gd, gf, ok, torch.from_numpy(ext), costs,
                                   True, changed, active)
    for b in range(B):
        n, h, w = ext[b]
        box = (b, slice(0, n), slice(0, h), slice(0, w))
        flag = torch.zeros(1, dtype=torch.int32)
        if bool(active[b]):
            wd, wf = tvoronoi._voronoi_sweep_plain(d[box], f[box], ok[box],
                                                  costs, True, flag)
        else:
            wd, wf = d[box], f[box]
        assert torch.equal(gd[box], wd) and torch.equal(gf[box], wf)
        assert int(changed[b]) == int(flag[0])
        outside = torch.ones((N, H, W), dtype=torch.bool)
        outside[:n, :h, :w] = False
        assert torch.equal(gd[b][outside], d[b][outside])
        assert torch.equal(gf[b][outside], f[b][outside])
    assert int(changed[:3].sum()) >= 1


def test_pack_lanes_fills_ctas_by_plane_count():
    """The kernel's packs: every live lane once, lanes by plane count
    (most first), at most `max_pack` lanes and `capacity` cells a pack, no
    dead lane; a live lane beyond `capacity` is refused, a dead one is
    not packed."""
    from kimimaro_tpu_torch.ops.voronoi import pack_lanes

    rng = np.random.RandomState(4)
    L = 200
    table = np.zeros((L, 6), dtype=np.int64)
    table[:, 1] = rng.randint(0, 40, L)
    table[:, 2] = rng.randint(1, 60, L)
    table[:, 3] = rng.randint(1, 60, L)
    table[5, 1:4] = (0, 80, 90)  # beyond the capacity, but dead
    capacity, max_pack = 3600, 8
    order, packs, used = pack_lanes(table, capacity, max_pack)
    live = np.flatnonzero(table[:, 1] > 0)
    assert sorted(order.tolist()) == live.tolist()
    assert (np.diff(table[order, 1]) <= 0).all()
    assert packs[0, 0] == 0 and (packs[1:, 0] == np.cumsum(packs[:-1, 1])
                                 ).all() and packs[:, 1].sum() == len(order)
    cells = table[:, 2] * table[:, 3]
    held = [int(cells[order[a:a + c]].sum()) for a, c in packs]
    assert (packs[:, 1] <= max_pack).all()
    assert max(held) <= capacity and used == max(held)
    table[5, 1] = 3
    with pytest.raises(ValueError, match="one CTA holds"):
        pack_lanes(table, capacity, max_pack)


def test_voronoi_lanes_beyond_the_capacity_take_the_single_form(
        monkeypatch):
    """With the lane capacity cut to 120 cells, the lanes with a larger
    plane in any of the three layouts take voronoi_feature_field alone,
    the others one batch; every lane equals JAX's field, the masks come
    back with `with_ok`, the batched sweep refuses a lane beyond the
    capacity."""
    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    monkeypatch.setattr(tvoronoi, "LANE_CELLS", 120)
    cases = _batch_cases()
    big = [max(y * z, x * z, x * y) > 120 for (x, y, z) in
           (ok.shape for ok, _ in cases)]
    assert 0 < sum(big) < len(cases)
    anis = (1.0, 2.0, 1.5)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = tgeo.voronoi_feature_field_batched(
            [ok for ok, _ in cases], [s for _, s in cases], anis,
            device="cpu", with_ok=True)
        counters = profiling.get_stats()["counters"]
    finally:
        profiling.collect(False)
    assert counters["voronoi_single_lanes"] == sum(big)
    assert counters["voronoi_batches"] == 1
    assert counters["voronoi_voxels"] == sum(
        ok.size for (ok, _), b in zip(cases, big) if not b)
    for (ok, seeds), (td, tf, tok) in zip(cases, got):
        jd, jf = jgeo.voronoi_feature_field(ok, seeds, anis)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tok.numpy(), ok)
    shape = (1, 3, 11, 11)
    with pytest.raises(ValueError, match="beyond 120 cells"):
        tvoronoi.voronoi_sweep_batched(
            torch.zeros(shape), torch.zeros(shape, dtype=torch.int32),
            torch.ones(shape, dtype=torch.bool), [(3, 11, 11)],
            tgeo.plane_costs(0, False, anis), False,
            torch.zeros(1, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# oversegment


def _blob_volume(seed, shape=(32, 28, 24), n_seeds=5):
    """Irregular 26-connected blobs (tests/test_gengine.py), one with an
    interior hole."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, dtype=np.uint32)
    for lab in range(1, n_seeds + 1):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        noise = rng.rand(*shape) * 0.4
        vol[((e + noise) < 1.0) & (vol == 0)] = lab
    vol[14:17, 12:15, 10:12] = 0
    return vol


def _to_jax(skel):
    return JSkeleton(skel.vertices.copy(), skel.edges.copy(),
                     skel.radii.copy() if skel.radii.size else None,
                     skel.vertex_types.copy() if skel.vertex_types.size
                     else None, segid=skel.id, space=skel.space,
                     transform=skel.transform.copy())


@pytest.fixture(scope="module")
def blob_skeletons():
    """The blob volume and its skeletons (the port's, on the CPU), the
    first with a vertex moved off its label inside its crop (a seed outside
    the mask: its raw id lands in the composite) and one moved out of the
    volume."""
    vol = _blob_volume(3)
    skels = kimimaro_tpu_torch.skeletonize(
        vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
        device="cpu")
    assert len(skels) >= 4
    lab = min(skels)
    pts = np.argwhere(vol == lab)
    lo, hi = pts.min(axis=0), pts.max(axis=0) + 1
    crop = vol[tuple(slice(a, b) for a, b in zip(lo, hi))]
    off = np.argwhere(crop != lab)[0] + lo
    skels[lab].vertices[0] = off.astype(np.float32) * np.array(ANIS)
    skels[lab].vertices[-1] = np.array([-3, 4, 4]) * np.array(ANIS)
    return vol, skels


def _assert_oversegment_equal(want, got):
    (wl, ws), (gl, gs) = want, got
    assert gl.dtype == wl.dtype == np.uint64
    np.testing.assert_array_equal(gl, wl)
    wlist = list(ws.values()) if isinstance(ws, dict) else (
        [ws] if hasattr(ws, "vertices") else ws)
    glist = list(gs.values()) if isinstance(gs, dict) else (
        [gs] if hasattr(gs, "vertices") else gs)
    assert len(wlist) == len(glist)
    for w, g in zip(wlist, glist):
        np.testing.assert_array_equal(g.segments, w.segments)
        assert g.segments.dtype == w.segments.dtype
        assert [a["id"] for a in g.extra_attributes] == \
            [a["id"] for a in w.extra_attributes]


@pytest.mark.parametrize("form", ("dict", "list", "single"))
@pytest.mark.parametrize("fill_holes", (False, True))
@pytest.mark.parametrize("downsample", (0, 5))
def test_oversegment_matches_jax(blob_skeletons, form, fill_holes,
                                 downsample):
    vol, skels = blob_skeletons
    jskels = {k: _to_jax(v) for k, v in skels.items()}
    if form == "list":
        skels, jskels = list(skels.values()), list(jskels.values())
    elif form == "single":
        big = max(skels, key=lambda k: len(skels[k].vertices))
        skels, jskels = skels[big], jskels[big]
    want = joversegment(vol, jskels, anisotropy=ANIS, fill_holes=fill_holes,
                        downsample=downsample)
    got = kimimaro_tpu_torch.oversegment(
        vol, skels, anisotropy=ANIS, fill_holes=fill_holes,
        downsample=downsample, device="cpu")
    _assert_oversegment_equal(want, got)
    assert len(np.unique(got[0])) > 2


@pytest.mark.parametrize("downsample", (0, 5))
def test_oversegment_fixture_of_the_jax_tests(downsample):
    """tests/test_xsection.py's test_oversegment fixture: a bar of 32 x 4 x
    4, its skeleton (the port's), split into territories."""
    labels = np.zeros((32, 8, 8), dtype=np.uint8)
    labels[2:30, 2:6, 2:6] = 1
    skels = kimimaro_tpu_torch.skeletonize(
        labels, teasar_params={"scale": 1.5, "const": 2}, dust_threshold=10,
        fix_borders=False, device="cpu")
    want = joversegment(labels, {k: _to_jax(v) for k, v in skels.items()},
                        downsample=downsample)
    got = kimimaro_tpu_torch.oversegment(labels, skels,
                                         downsample=downsample, device="cpu")
    _assert_oversegment_equal(want, got)
    new_labels, new_skels = got
    assert new_labels[labels == 0].max() == 0
    assert len(np.unique(new_labels)) - 1 >= 2
    assert len(new_skels[1].segments) == len(new_skels[1].vertices)
    assert np.all(new_skels[1].segments > 0)


@pytest.mark.parametrize("downsample", (0, 5))
def test_oversegment_batches_equal_the_per_crop_route(blob_skeletons,
                                                      downsample,
                                                      monkeypatch):
    """The batched fields in one batch, in batches of a few crops each
    (BATCH_BYTES cut), and the per-crop route (voronoi_feature_field on
    each crop) give the same composite and segments; the counters keep
    their meaning."""
    import importlib

    tovs = importlib.import_module("kimimaro_tpu_torch.oversegment")
    vol, skels = blob_skeletons
    runs = []
    for budget in (1 << 30, 50_000, None):
        profiling.reset_stats()
        profiling.collect(True)
        try:
            if budget:
                monkeypatch.setattr(tovs, "BATCH_BYTES", budget)
            runs.append((tovs._oversegment(
                vol, skels, ANIS, False, False, False, downsample, "cpu",
                per_crop=budget is None),
                profiling.get_stats()["counters"]))
        finally:
            profiling.collect(False)
    (one, c1), (few, c2), (per, c3) = runs
    _assert_oversegment_equal(per, one)
    _assert_oversegment_equal(per, few)
    assert c1["voronoi_batches"] == 1 < c2["voronoi_batches"]
    assert "voronoi_batches" not in c3
    assert c1["voronoi_rounds"] == c2["voronoi_rounds"] == \
        c3["voronoi_rounds"] > 0


def test_oversegment_sends_crops_beyond_the_lane_capacity_alone(
        blob_skeletons, monkeypatch):
    """With the lane capacity cut below the blob's larger crops' planes,
    those crops take voronoi_feature_field alone beside the batch, with
    the per-crop route's composite, segments and lane-rounds."""
    import importlib

    from kimimaro_tpu_torch.ops import voronoi as tvoronoi

    tovs = importlib.import_module("kimimaro_tpu_torch.oversegment")
    vol, skels = blob_skeletons
    monkeypatch.setattr(tvoronoi, "LANE_CELLS", 150)
    runs = []
    for per_crop in (False, True):
        profiling.reset_stats()
        profiling.collect(True)
        try:
            runs.append((tovs._oversegment(
                vol, skels, ANIS, False, False, False, 0, "cpu",
                per_crop=per_crop), profiling.get_stats()["counters"]))
        finally:
            profiling.collect(False)
    (got, c1), (per, c2) = runs
    _assert_oversegment_equal(per, got)
    assert 0 < c1["voronoi_single_lanes"] < len(skels)
    assert c1["voronoi_batches"] >= 1
    assert c1["voronoi_rounds"] == c2["voronoi_rounds"] > 0


def test_renumber_first_appearance_matches_numpy():
    from kimimaro_tpu_torch.oversegment import renumber_first_appearance

    rng = np.random.RandomState(5)
    for bg in (True, False):
        vol = rng.randint(0 if bg else 3, 40, size=(7, 9, 5)) * 1000
        uniq, first, inv = np.unique(vol, return_index=True,
                                     return_inverse=True)
        fg = slice(1, None) if bg else slice(None)
        new = np.empty(len(uniq[fg]), dtype=np.int64)
        new[np.argsort(first[fg], kind="stable")] = np.arange(1, len(new) + 1)
        want = (np.concatenate([[0], new]) if bg else new)[inv.ravel()]
        got = renumber_first_appearance(torch.from_numpy(vol))
        np.testing.assert_array_equal(got.numpy().ravel(), want)


# --------------------------------------------------------------------------- #
# point_to_point and connect_points


def _tube(shape, seed, radius=1.6, steps=60):
    """A persistent random walk, thickened to a tube, inside `shape`;
    returns (mask, start, end) with start and end on the walk's ends."""
    rng = np.random.RandomState(seed)
    p = np.array(shape, np.float64) / 2
    heading = rng.randn(3)
    path = []
    for _ in range(steps):
        heading = heading / np.linalg.norm(heading) + 0.6 * rng.randn(3)
        step = heading / np.linalg.norm(heading)
        q = p + step
        for a in range(3):
            if not radius + 1 <= q[a] <= shape[a] - radius - 2:
                heading[a] = -heading[a]
                step[a] = -step[a]
        p = np.clip(p + step, radius + 1, np.array(shape) - radius - 2)
        path.append(p.copy())
    g = np.indices(shape).transpose(1, 2, 3, 0).astype(np.float64)
    mask = np.zeros(shape, dtype=bool)
    for q in path:
        mask |= ((g - q) ** 2).sum(-1) <= radius ** 2
    start = tuple(int(round(c)) for c in path[0])
    end = tuple(int(round(c)) for c in path[-1])
    assert mask[start] and mask[end]
    return mask, start, end


def _assert_same_skeleton(a, b):
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.edges, a.edges)
    np.testing.assert_array_equal(b.radii, a.radii)
    assert b.radii.dtype == a.radii.dtype


@pytest.mark.parametrize("anis", ((1.0, 1.0, 1.0), ANIS))
def test_point_to_point_matches_jax(anis):
    mask, start, end = _tube((20, 18, 14), seed=1)
    want = jtrace.point_to_point(mask, start, end, anisotropy=anis)
    got = ttrace.point_to_point(mask, start, end, anisotropy=anis,
                                device="cpu")
    assert len(want.vertices) > 5
    _assert_same_skeleton(want, got)
    # the path runs from `end` (the field's source) to `start`
    assert tuple(got.vertices[0].astype(int)) == end
    assert tuple(got.vertices[-1].astype(int)) == start


def test_connect_points_matches_jax():
    mask, start, end = _tube((20, 18, 14), seed=2)
    labels = mask.astype(np.uint8) * 3
    want = kimimaro_tpu.connect_points(labels, start, end, anisotropy=ANIS)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.connect_points(labels, start, end,
                                                anisotropy=ANIS, device="cpu")
    finally:
        profiling.collect(False)
    _assert_same_skeleton(want, got)
    assert got.space == want.space == "physical"
    # each phase and the blocking reads it waited in
    assert set(profiling.get_stats()["phases"]) == {
        "connect_ccl", "point_to_point", "connect_ccl_wait",
        "point_to_point_wait"}


def test_connect_points_2d_and_disconnected():
    rng = np.random.RandomState(4)
    img = np.zeros((24, 20), dtype=bool)
    img[3, 2:18] = img[3:20, 17] = img[19, 4:18] = True
    img[4:6, 5:9] = rng.rand(2, 4) < 0.5
    want = kimimaro_tpu.connect_points(img, (3, 2), (19, 4),
                                       anisotropy=(4, 4, 40))
    got = kimimaro_tpu_torch.connect_points(img, (3, 2), (19, 4),
                                            anisotropy=(4, 4, 40),
                                            device="cpu")
    _assert_same_skeleton(want, got)
    apart = np.zeros((10, 10, 10), dtype=bool)
    apart[1:4, 1:4, 1:4] = apart[6:9, 6:9, 6:9] = True
    for fn in (kimimaro_tpu.connect_points,
               lambda *a: kimimaro_tpu_torch.connect_points(*a,
                                                            device="cpu")):
        with pytest.raises(ValueError, match="disconnected"):
            fn(apart, (2, 2, 2), (7, 7, 7))
        with pytest.raises(ValueError, match="disconnected"):
            fn(apart, (0, 0, 0), (2, 2, 2))


# --------------------------------------------------------------------------- #
# synapses_to_targets


# the second label's value in each volume dtype, and its key
_SYN_SECOND = {"uint64": (2**40 + 2, 2**40 + 2), "int16": (-3, -3),
               "float32": (2.5, 2.5)}


def _synapse_case(seed, kind="uint64"):
    """A labelled volume of dtype `kind` and synapses: several SWC labels
    per label, ties between voxels, a label absent from the volume, keys
    that equal no voxel in the volume's dtype."""
    value, key = _SYN_SECOND[kind]
    vol = _blob_volume(seed, shape=(20, 18, 16), n_seeds=4).astype(kind)
    vol[vol == 2] = value
    rng = np.random.RandomState(seed)
    syn = {}
    for lab in (1, key, 3, 4, 77, 3.5, 2**70):
        pairs = []
        for k in range(5):
            c = tuple(float(v) for v in rng.uniform(0, 18, size=3))
            pairs.append((c, [1, 2, 3][k % 3]))
        pairs.append(((10.5, 9.0, 8.0), 4))  # a tie between voxels
        syn[lab] = pairs
    return vol, syn


@pytest.mark.parametrize("kind", tuple(_SYN_SECOND))
@pytest.mark.parametrize("ndim", (3, 4))
def test_synapses_to_targets_matches_jax(ndim, kind):
    vol, syn = _synapse_case(7, kind)
    if ndim == 4:
        vol = vol[..., np.newaxis]
    want = jintake.synapses_to_targets(vol, syn)
    got = tintake.synapses_to_targets(vol, syn)
    assert got == want
    assert len(got) > 8


def test_synapses_to_targets_2d_matches_jax():
    """A 2-D volume: its labels' voxels and the targets in two axes."""
    vol, syn = _synapse_case(9)
    vol = vol[:, :, 7]
    syn = {k: [(c[:2], s) for c, s in v] for k, v in syn.items()}
    want = jintake.synapses_to_targets(vol, syn)
    assert tintake.synapses_to_targets(vol, syn) == want
    assert len(want) > 8


def test_synapse_targets_become_vertices():
    """synapses_to_targets -> skeletonize(extra_targets_after=...): every
    target is a vertex of its label's skeleton, in the port and in the JAX
    package alike (the JAX side through its crop-engine path)."""
    vol = _blob_volume(5, shape=(24, 22, 18), n_seeds=3)
    rng = np.random.RandomState(1)
    syn = {lab: [(tuple(float(v) for v in rng.uniform(2, 16, size=3)), 1),
                 (tuple(float(v) for v in rng.uniform(2, 16, size=3)), 2)]
           for lab in (1, 2, 3)}
    targets = tintake.synapses_to_targets(vol, syn)
    assert targets == jintake.synapses_to_targets(vol, syn)
    kw = dict(teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
              extra_targets_after=list(targets.keys()))
    want = kimimaro_tpu.skeletonize(vol, **kw)
    got = kimimaro_tpu_torch.skeletonize(vol, device="cpu", **kw)
    for skels in (want, got):
        for t in targets:
            lab = int(vol[t])
            verts = {tuple(v) for v in skels[lab].vertices.tolist()}
            assert tuple(float(c * a) for c, a in zip(t, ANIS)) in verts


# --------------------------------------------------------------------------- #
# renumber_cc


@pytest.mark.parametrize("background", (True, False))
def test_renumber_cc_matches_jax(background):
    rng = np.random.RandomState(11)
    cc_raw = rng.randint(0 if background else 5, 60, size=(9, 8, 7)) * 31
    orig = rng.randint(1, 9, size=cc_raw.shape).astype(np.uint32)
    wc, wm = jccl.renumber_cc(cc_raw, orig)
    gc, gm = tccl.renumber_cc(cc_raw, orig, device="cpu")
    np.testing.assert_array_equal(gc, wc)
    assert gc.dtype == wc.dtype
    assert gm == wm


# --------------------------------------------------------------------------- #
# invalidation_cube (tests/test_invalidation_cube.py's fuzz cases)


def _cube_equal(labels, dbf, path, scale, const, anis):
    wn, wl = jgeo.invalidation_cube(labels, dbf, path, scale, const, anis)
    gn, gl = tgeo.invalidation_cube(torch.from_numpy(labels),
                                    torch.from_numpy(dbf), path, scale,
                                    const, anis)
    assert int(gn) == int(wn)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    return int(gn)


@pytest.mark.parametrize("seed", range(8))
def test_invalidation_cube_fuzz_matches_jax(seed):
    rng = np.random.RandomState(seed)
    shape = tuple(rng.randint(6, 14, size=3))
    labels = (rng.rand(*shape) < 0.7).astype(np.uint8)
    dbf = rng.uniform(0, 4, size=shape).astype(np.float32) * labels
    npath = rng.randint(1, 4)
    path = np.stack([rng.randint(0, s, size=npath) for s in shape], axis=1)
    scale = float(rng.uniform(0.5, 2.0))
    const = float(rng.uniform(0.0, 2.0))
    anis = tuple(rng.uniform(0.5, 2.0, size=3))
    _cube_equal(labels, dbf, path, scale, const, anis)


@pytest.mark.parametrize("chunk", range(10))
def test_invalidation_cube_fuzz_wide_matches_jax(chunk):
    shape = (11, 9, 13)
    anis_menu = [(1, 1, 1), (0.5, 1.3, 2.0), (2.0, 2.0, 0.7), (16, 16, 40)]
    for seed in range(10 * chunk, 10 * chunk + 10):
        rng = np.random.RandomState(1000 + seed)
        labels = (rng.rand(*shape) < rng.uniform(0.3, 0.9)).astype(np.uint8)
        dbf = rng.uniform(0, 5, size=shape).astype(np.float32) * labels
        path = np.stack([rng.randint(0, s, size=3) for s in shape], axis=1)
        scale = float(rng.uniform(0.0, 2.5))
        const = float(rng.uniform(0.0, 3.0))
        _cube_equal(labels, dbf, path, scale, const,
                    anis_menu[seed % len(anis_menu)])


@pytest.mark.parametrize("scale,dbf,const,want", [
    # scale * dbf + const: 1.9999998 fused (a 3^3 box), 2.0 in two
    # roundings (5^3); then the other way round
    (1.9454942, 4.3395634, -6.4425955, 27),
    (1.2933424, 1.5770074, -0.039610475, 125),
])
def test_invalidation_cube_radius_is_fused_as_in_jax(scale, dbf, const, want):
    labels = np.ones((9, 9, 9), dtype=np.uint8)
    field = np.full(labels.shape, np.float32(dbf), dtype=np.float32)
    assert _cube_equal(labels, field, [(4, 4, 4)], float(np.float32(scale)),
                       float(np.float32(const)), (1, 1, 1)) == want


def test_invalidation_cube_skips_and_wraps_vertices_like_jax():
    """A vertex with v[0] < 0 is skipped; other negative coordinates read
    the DBF by JAX's rule and centre the box outside the volume; boxes
    clamp at the borders."""
    rng = np.random.RandomState(3)
    labels = (rng.rand(8, 9, 10) < 0.8).astype(np.int32) * 7
    dbf = rng.uniform(0, 3, size=labels.shape).astype(np.float32)
    path = [(-1, 3, 3), (2, -2, 4), (7, 8, 12), (0, 0, 0)]
    _cube_equal(labels, dbf, path, 1.1, 0.4, (1.0, 2.0, 0.8))


@pytest.mark.parametrize("op", ("voronoi_feature_field", "invalidation_cube"))
def test_ops_take_numpy_arrays_as_jax_does(op):
    """The ops take numpy arrays where the JAX twins do (on the device
    asked for, here the CPU)."""
    if op == "voronoi_feature_field":
        ok, seeds, anis = _voronoi_case("aniso")
        want = jgeo.voronoi_feature_field(ok, seeds, anis)
        got = tgeo.voronoi_feature_field(ok, seeds, anis, device="cpu")
    else:
        rng = np.random.RandomState(5)
        labels = (rng.rand(9, 8, 7) < 0.8).astype(np.uint8)
        dbf = rng.uniform(0, 3, size=labels.shape).astype(np.float32)
        args = (labels, dbf, [(4, 4, 3), (1, 6, 2)], 1.3, 0.5, (1, 2, 1.5))
        want = jgeo.invalidation_cube(*args)
        got = tgeo.invalidation_cube(*args, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------- #
# the device of numpy input


def _numpy_calls():
    """Each function of kimimaro_tpu_torch.ops.__all__, and the trace
    entry points, called with numpy input and no device."""
    from kimimaro_tpu_torch import ops as tops

    ok = np.ones((4, 5, 6), dtype=bool)
    lab = ok.astype(np.uint32)
    dbf = np.ones(ok.shape, dtype=np.float32)
    init = np.where(ok, np.inf, 0).astype(np.float32)
    path = np.array([[1, 1, 1]])
    return {
        "connected_components": lambda: tops.connected_components(lab),
        "renumber_cc": lambda: tops.renumber_cc(lab, lab),
        "edt_transform": lambda: tops.edt_transform(lab),
        "edtsq": lambda: tops.edtsq(lab),
        "fill_voids": lambda: tops.fill_voids(ok),
        "distance_field": lambda: tops.distance_field(ok, init),
        "euclidean_distance_field": lambda: tops.euclidean_distance_field(
            ok, (0, 0, 0)),
        "flood_fill": lambda: tops.flood_fill(ok, ok),
        "invalidation_ball": lambda: tops.invalidation_ball(
            ok, dbf, path, 1.0, 1.0),
        "invalidation_cube": lambda: tops.invalidation_cube(
            lab, dbf, path, 1.0, 1.0),
        "parent_field": lambda: tops.parent_field(dbf, ok),
        "voronoi_feature_field": lambda: tops.voronoi_feature_field(
            ok, path),
        "voronoi_feature_field_batched":
            lambda: tgeo.voronoi_feature_field_batched([ok], [path]),
        "trace": lambda: ttrace.trace(lab, dbf),
        "point_to_point": lambda: ttrace.point_to_point(ok, (0, 0, 0),
                                                        (3, 4, 5)),
    }


@pytest.mark.parametrize("name", sorted(_numpy_calls()))
def test_numpy_input_goes_to_the_card_by_default(name, monkeypatch):
    """Without CUDA, numpy input and no `device` raise: the default is the
    card, never a quiet run on the CPU."""
    from kimimaro_tpu_torch import ops as tops

    if name in tops.__all__:
        assert callable(getattr(tops, name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _numpy_calls()[name]()


def test_numpy_calls_cover_every_op_function():
    from kimimaro_tpu_torch import ops as tops

    funcs = {n for n in tops.__all__
             if callable(getattr(tops, n))
             and not isinstance(getattr(tops, n), type(tops))}
    assert funcs <= set(_numpy_calls())

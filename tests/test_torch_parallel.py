"""The port's multi-device path (kimimaro_tpu_torch.parallel) against the
JAX package's (kimimaro_tpu.parallel) on the CPU: the port's meshes of 4
and 8 CPU shards against JAX's virtual meshes of the same sizes. Sharded
EDT, distance rounds, CCL, the preamble step, the sharded global engine
and skeletonize_sharded are bit-equal (values, paths, radii, SWC); the
sharded skeletons equal the port's own single-device ones; the crop
gathers are batched and no step gathers the whole volume."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import kimimaro_tpu_torch
from kimimaro_tpu.ops.stencils import GRAPH_BITS
from kimimaro_tpu.parallel import gengine as jg
from kimimaro_tpu.parallel import sharded as js
from kimimaro_tpu.parallel import skeletonize_sharded as jskel
from kimimaro_tpu_torch.ops import edt as tedt
from kimimaro_tpu_torch.ops.ccl import compact_cc, connected_components
from kimimaro_tpu_torch.ops.fma import fma_f32
from kimimaro_tpu_torch.parallel import comm
from kimimaro_tpu_torch.parallel import gengine as tg
from kimimaro_tpu_torch.parallel import sharded as ts
from kimimaro_tpu_torch.parallel import skeletonize as tsk
from kimimaro_tpu_torch.parallel import skeletonize_sharded as tskel
from kimimaro_tpu_torch.trace import integer_pow

from test_sharded_gengine import ANIS, TEASAR, _prep
from test_torch_fma import _fma_volume
from test_torch_voxel_graph import blob_volume, self_touch

torch.set_num_threads(1)

N_DEV = min(8, len(jax.devices()))
ALL = np.uint32((1 << 26) - 1)

_JMESH = {}


def _jmesh(n):
    if n not in _JMESH:
        _JMESH[n] = js.make_mesh(n)
    return _JMESH[n]


def _tmesh(n):
    return ts.make_mesh(n, "cpu")


def _host(sv):
    return np.concatenate([s.numpy() for s in sv.slabs])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def random_labels(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 3, size=shape).astype(np.int32)


def _wall_graph(shape, x):
    """An all-ones graph with a wall between planes x and x + 1."""
    vg = np.full(shape, ALL, dtype=np.uint32)
    lo = hi = np.uint32(ALL)
    for o, b in GRAPH_BITS.items():
        if o[0] == 1:
            lo &= np.uint32(~(1 << b) & 0x3FFFFFF)
        if o[0] == -1:
            hi &= np.uint32(~(1 << b) & 0x3FFFFFF)
    vg[x] = lo
    vg[x + 1] = hi
    return vg


def _vg_labels():
    rng = np.random.RandomState(3)
    labels = (rng.rand(8, 6, 5) > 0.3).astype(np.uint8)
    return labels, _wall_graph(labels.shape, 3)


# --------------------------------------------------------------------------- #
# the mesh


def test_make_mesh_places_and_prints_its_shards():
    m = ts.make_mesh(3, "cpu")
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert repr(m) == "Mesh(shard: cpu, cpu, cpu)"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.make_mesh(4, "cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tskel(np.ones((4, 4, 4), np.uint32), n_devices=2)
    with pytest.raises(ValueError):
        ts.shard_volume(np.zeros((10, 4, 4), np.int32), _tmesh(4))


def test_sharded_volume_crops_match_slicing():
    vol = np.arange(16 * 5 * 6, dtype=np.int32).reshape(16, 5, 6)
    sv = ts.shard_volume(vol, _tmesh(4))
    for index in [(slice(2, 11), slice(1, 4), slice(0, 6)), (5, 2, 3),
                  (slice(None), slice(None), 0), (-1, slice(None)),
                  (slice(3, 4), 4, slice(2, 5)), (slice(7, 7),)]:
        comm.reset_exchanges()
        np.testing.assert_array_equal(sv[index].numpy(), vol[index])
        # every region read is one counted exchange of comm
        assert comm.EXCHANGES["crop"] == 1
    view = sv.rows(10)
    assert view.shape == (10, 5, 6)
    np.testing.assert_array_equal(view[-1].numpy(), vol[9])


# --------------------------------------------------------------------------- #
# the preamble, bit for bit


@pytest.mark.parametrize("n", (4, 8))
def test_sharded_edt_matches_jax_and_the_single_device_edt(n):
    labels = random_labels((16, 8, 8))
    anis = (2.0, 1.0, 1.5)
    want = js.sharded_edtsq(js.shard_volume(labels, _jmesh(n)), _jmesh(n),
                            anis)
    got = _host(ts.sharded_edtsq(labels, _tmesh(n), anis))
    _equal(got, want)
    single = tedt.edtsq(torch.from_numpy(labels), anis).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-4)


def test_sharded_edt_black_border_matches_jax():
    labels = np.ones((16, 8, 8), dtype=np.int32)
    m = _jmesh(4)
    want = js.sharded_edtsq(js.shard_volume(labels, m), m, (1.0, 1.0, 1.0),
                            True)
    got = _host(ts.sharded_edtsq(labels, _tmesh(4), (1.0, 1.0, 1.0), True))
    _equal(got, want)


def test_sharded_edt_and_ccl_with_a_voxel_graph_match_jax():
    labels, vg = _vg_labels()
    m = _jmesh(4)
    lab_j, vg_j = js.shard_volume(jnp.asarray(labels), m), \
        js.shard_volume(jnp.asarray(vg), m)
    tm = _tmesh(4)
    _equal(_host(ts.sharded_edtsq(labels, tm, (2.0, 1.0, 1.0), True,
                                  voxel_graph=vg)),
           js.sharded_edtsq(lab_j, m, (2.0, 1.0, 1.0), black_border=True,
                            voxel_graph=vg_j))
    for rounds in (None, 2):
        _equal(_host(ts.sharded_ccl_rounds(labels, tm, rounds,
                                           voxel_graph=vg)),
               js.sharded_ccl_rounds(lab_j, m, rounds, voxel_graph=vg_j))


@pytest.mark.parametrize("n", (4, 8))
def test_sharded_self_touch_ccl_matches_jax_and_the_single_device(n):
    """The sharded CCL to its fixpoint under the pre-merge graph of a
    self-touch volume (each slab's gate built from its labels and graph
    extended by the halo planes) against JAX's sharded function and the
    single-device CCL: the pre-merge components."""
    pre = blob_volume(6, shape=(16, 12, 10), n_seeds=6)
    merged, vg, _ = self_touch(pre)
    merged = merged.astype(np.int32)
    m = _jmesh(n)
    want = js.sharded_ccl_rounds(
        js.shard_volume(jnp.asarray(merged), m), m, None,
        voxel_graph=js.shard_volume(jnp.asarray(vg), m))
    got = _host(ts.sharded_ccl_rounds(merged, _tmesh(n), None,
                                      voxel_graph=vg))
    _equal(got, want)
    single = connected_components(torch.from_numpy(merged),
                                  torch.from_numpy(vg), device="cpu")
    _equal(got, single.numpy())
    assert len(np.unique(got)) == len(np.unique(
        connected_components(torch.from_numpy(pre.astype(np.int32)),
                             device="cpu").numpy()))


@pytest.mark.parametrize("n,rounds", [(4, None), (4, 10), (8, 3)])
def test_sharded_distance_rounds_match_jax(n, rounds):
    labels = np.zeros((16, 8, 8), dtype=np.int32)
    labels[:, 3:5, 3:5] = 1
    labels[5:9, 1:7, 2:6] = 1
    ok = labels != 0
    init = np.full(labels.shape, np.inf, dtype=np.float32)
    init[0, 3, 3] = 0.0
    nc = np.random.RandomState(2).uniform(0.5, 2.0, ok.shape).astype(
        np.float32)
    m = _jmesh(n)
    for node_cost in (None, nc):
        want = js.sharded_distance_rounds(
            js.shard_volume(jnp.asarray(init), m),
            js.shard_volume(jnp.asarray(ok), m), m, (1.0, 2.0, 1.5),
            node_cost=None if node_cost is None
            else js.shard_volume(jnp.asarray(node_cost), m), rounds=rounds)
        got = ts.sharded_distance_rounds(init, ok, _tmesh(n),
                                         (1.0, 2.0, 1.5),
                                         node_cost=node_cost, rounds=rounds)
        _equal(_host(got), want)


@pytest.mark.parametrize("n,rounds", [(4, 16), (8, None), (4, 1)])
def test_sharded_ccl_rounds_match_jax(n, rounds):
    labels = np.zeros((16, 8, 8), dtype=np.int32)
    labels[:, 1:3, 1:3] = 5
    labels[2:4, 5:7, 5:7] = 5
    labels[6:12, 4:7, 0:3] = 2
    m = _jmesh(n)
    want = js.sharded_ccl_rounds(js.shard_volume(labels, m), m, rounds)
    got = ts.sharded_ccl_rounds(labels, _tmesh(n), rounds)
    _equal(_host(got), want)


def test_sharded_compaction_and_label_info_match_single_device():
    labels = random_labels((16, 8, 8), seed=4) * 7
    tm = _tmesh(4)
    lab = ts.shard_volume(labels, tm)
    cc, n_comp, roots = tsk._compact_cc_sharded(ts.sharded_ccl_rounds(lab,
                                                                      tm))
    want, n_want, _ = compact_cc(connected_components(labels, device="cpu"))
    assert n_comp == n_want
    np.testing.assert_array_equal(_host(cc), want.numpy())
    dbf = ts.sharded_edtsq(lab, tm, (1.0, 1.0, 1.0))
    counts, bbmin, bbmax, orig, dbfmax = tsk._label_info_sharded(
        cc, lab, 1 << int(np.ceil(np.log2(n_comp))), roots, dbf)
    cc_h, dbf_h = want.numpy(), _host(dbf)
    for k in range(1, n_comp + 1):
        pts = np.argwhere(cc_h == k)
        assert counts[k] == len(pts)
        np.testing.assert_array_equal(bbmin[k], pts.min(axis=0))
        np.testing.assert_array_equal(bbmax[k], pts.max(axis=0))
        assert orig[k] == labels[tuple(pts[0])]
        assert dbfmax[k] == dbf_h[cc_h == k].max()


def test_preamble_step_matches_jax():
    n = N_DEV
    labels = random_labels((16, 8, 8), seed=1)
    m = _jmesh(n)
    want = js.preamble_step(js.shard_volume(labels, m), m, (1.0, 1.0, 1.0))
    got = ts.preamble_step(labels, _tmesh(n), (1.0, 1.0, 1.0))
    for k in ("dbf", "pdrf", "cc", "daf"):
        _equal(_host(got[k]), want[k])
    assert (_host(got["dbf"])[labels == 0] == 0).all()


# --------------------------------------------------------------------------- #
# the sharded global engine


def _same_paths(want, got):
    assert set(want) == set(got)
    for k in want:
        assert len(want[k]) == len(got[k]), k
        for (v1, r1), (v2, r2) in zip(want[k], got[k]):
            np.testing.assert_array_equal(v2, v1)
            _equal(r2, r1)


def _both_engines(vol, jobs_edit=None, teasar=TEASAR, n=N_DEV):
    cc_dev, dbf_dev, jobs = _prep(vol)
    if jobs_edit is not None:
        jobs_edit(np.asarray(cc_dev), jobs)
    m = _jmesh(n)
    want = jg.trace_global_sharded(
        js.shard_volume(cc_dev, m), js.shard_volume(dbf_dev, m),
        [dict(j) for j in jobs], teasar, ANIS, True, m)
    tm = _tmesh(n)
    got = tg.trace_global_sharded(
        ts.shard_volume(np.asarray(cc_dev), tm),
        ts.shard_volume(np.asarray(dbf_dev), tm), [dict(j) for j in jobs],
        teasar, ANIS, True, tm)
    return want, got


class _Capture:
    """The sharded engines' PDRF (the JAX setup's output) and the seeds of
    every invalidation ball (-radius at each path voxel: the JAX side
    through jax.debug.callback inside its jitted shard_map iteration,
    per shard; the port's at its relax)."""

    def __init__(self, monkeypatch):
        self.jball, self.pball, self.terms = [], [], []
        # the JAX programs are traced anew with the wrappers below
        jg._setup_impl.cache_clear()
        jg._iteration_impl.cache_clear()
        real_setup = jg._setup_impl

        def setup(*a, **k):
            fn = real_setup(*a, **k)

            def call(*args):
                out = fn(*args)
                self.jpdrf = np.asarray(out[2])
                return out
            return call

        real_relax = jg._relax_fixpoint_cc

        def relax(d, cc_eff, nc, anis, mode, clamp, n_dev, max_rounds):
            if clamp:
                jax.debug.callback(
                    lambda i, x: self.jball.append((int(i), np.array(x))),
                    jax.lax.axis_index(js.AXIS), d)
            return real_relax(d, cc_eff, nc, anis, mode, clamp, n_dev,
                              max_rounds)

        real_pf = tg.pdrf_field

        def pdrf_field(*a):
            self.terms.append(a[:4])
            return real_pf(*a)

        real_trelax = tg._relax_fixpoint_cc

        def trelax(d, cc, nc, anis, mode, clamp, mesh, max_rounds):
            if clamp:
                self.pball.append(np.concatenate([x.numpy() for x in d]))
            return real_trelax(d, cc, nc, anis, mode, clamp, mesh,
                               max_rounds)

        monkeypatch.setattr(jg, "_setup_impl", setup)
        monkeypatch.setattr(jg, "_relax_fixpoint_cc", relax)
        monkeypatch.setattr(tg, "pdrf_field", pdrf_field)
        monkeypatch.setattr(tg, "_relax_fixpoint_cc", trelax)

    def jax_balls(self):
        jax.effects_barrier()
        by_shard = {}
        for i, x in self.jball:
            by_shard.setdefault(i, []).append(x)
        shards = sorted(by_shard)
        return [np.concatenate([by_shard[i][k] for i in shards])
                for k in range(len(by_shard[shards[0]]))]


def test_sharded_gengine_and_its_fma_sites_match_jax(monkeypatch):
    """The sharded engine's paths and radii equal the JAX package's, and
    Queue C 5's sites of the sharded engine are decided voxel for voxel
    against the values inside the JAX package's jitted shard_map code:
    `1 - dbf*m` fused, `p*pdrf_scale + daf*imd` fused with the DAF term
    as the product, dbf^1.01 as trace.pow_1_01, and the ball radii
    `scale*dbf + const` fused. The unfused forms differ on this volume."""
    teasar = dict(TEASAR, scale=3.3, const=7.9)
    cap = _Capture(monkeypatch)
    vol = _fma_volume()
    (res1, left1), (res2, left2) = _both_engines(vol, teasar=teasar, n=4)
    assert len(res1) >= 3
    _same_paths(res1, res2)
    assert [j["segid"] for j in left1] == [j["segid"] for j in left2]

    fg = vol != 0
    want = cap.jpdrf

    def variant(fn):
        return np.concatenate([fn(*t).numpy() for t in cap.terms])

    s = float(np.float32(teasar["pdrf_scale"]))
    e = teasar["pdrf_exponent"]
    chosen = variant(lambda d, a, m, i: fma_f32(
        a, i, integer_pow(fma_f32(d, m, 1.0, negate=True), e) * s))
    plain_p = variant(lambda d, a, m, i: fma_f32(
        a, i, integer_pow(1.0 - d * m, e) * s))
    plain_sum = variant(lambda d, a, m, i: integer_pow(
        fma_f32(d, m, 1.0, negate=True), e) * s + a * i)
    # the roots hold 0 after the setup zeroes them
    roots = fg & (want == 0)
    keep = fg & ~roots

    def n_diff(x):
        return int((_bits(x) != _bits(want))[keep].sum())

    assert n_diff(chosen) == 0
    assert n_diff(plain_p) > 0 and n_diff(plain_sum) > 0

    jballs, pballs = cap.jax_balls(), cap.pball
    assert len(jballs) == len(pballs) > 0
    dbf = np.asarray(_prep(vol)[1])
    n_plain = 0
    for w, g in zip(jballs, pballs):
        _equal(g, w)
        at = np.isfinite(w)
        plain = -(dbf[at] * np.float32(teasar["scale"])
                  + np.float32(teasar["const"]))
        n_plain += int((plain != w[at]).sum())
    assert n_plain > 0


def test_sharded_gengine_manual_targets_and_roots_match_jax():
    def edit(cc_h, jobs):
        big = sorted(jobs, key=lambda j: -int(np.prod(j["shape"])))[:2]
        for j in big:
            vox = np.argwhere(cc_h == j["segid"])
            j["root"] = tuple(int(c) - int(m)
                              for c, m in zip(vox[0], j["offset"]))
            j["before"] = [tuple(int(c) - int(m)
                                 for c, m in zip(vox[-1], j["offset"]))]

    # the volume and mesh of the test above: its JAX programs are reused
    (res1, _), (res2, _) = _both_engines(_fma_volume(), edit, n=4)
    assert len(res1) >= 3
    _same_paths(res1, res2)


# --------------------------------------------------------------------------- #
# skeletonize_sharded


def _vertex_set(skel):
    return set(map(tuple, np.round(skel.vertices, 3).tolist()))


def two_label_volume():
    labels = np.zeros((16, 24, 8), dtype=np.uint32)
    labels[2:14, 4:8, 2:6] = 7
    labels[4:12, 14:20, 2:6] = 9
    return labels


def _padded():
    labels = np.zeros((10, 12, 8), dtype=np.uint32)
    labels[1:9, 4:8, 2:6] = 3
    return labels


def _tube():
    labels = np.zeros((8, 12, 8), dtype=np.uint32)
    labels[:, 3:5, 3:5] = 2
    return labels


def _bar_with_wall():
    labels = np.zeros((16, 12, 8), dtype=np.uint32)
    labels[2:14, 4:8, 2:6] = 7
    return labels, _wall_graph(labels.shape, 7)


def _six_bars():
    labels = np.zeros((32, 24, 16), dtype=np.uint32)
    for i, (x, y) in enumerate([(2, 2), (2, 12), (12, 2), (12, 12),
                                (22, 2), (22, 12)]):
        labels[x:x + 8, y:y + 4, 4:10] = i + 1
    return labels


CASES = {
    "two_labels": (two_label_volume, N_DEV, {}),
    "padded_axis": (_padded, 4, {}),
    "single_label_black_border": (lambda: np.ones((8, 12, 8), np.uint32), 4,
                                  {}),
    "fix_borders": (_tube, 4, {"fix_borders": True}),
    "voxel_graph": (None, 4, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_skeletonize_sharded_matches_jax_and_single_device(case):
    make, n, kw = CASES[case]
    vg = None
    if case == "voxel_graph":
        labels, vg = _bar_with_wall()
    else:
        labels = make()
    args = dict(anisotropy=(1, 1, 1), dust_threshold=10, voxel_graph=vg,
                **kw)
    want = jskel(labels, mesh=_jmesh(n), **args)
    got = tskel(labels, mesh=_tmesh(n), **args)
    assert sorted(want) == sorted(got) and len(got) >= 1
    for k in want:
        assert got[k].to_swc() == want[k].to_swc()
    single = kimimaro_tpu_torch.skeletonize(labels, device="cpu", **args)
    assert sorted(single) == sorted(got)
    for k in single:
        assert _vertex_set(single[k]) == _vertex_set(got[k])
        assert abs(single[k].cable_length() - got[k].cable_length()) < 1e-3


def test_skeletonize_sharded_never_gathers_the_full_volume(monkeypatch):
    labels = np.zeros((32, 24, 16), dtype=np.uint32)
    labels[4:18, 4:8, 4:8] = 5
    labels[20:30, 12:16, 8:12] = 6
    seen = []
    real_fetch, real_crop = comm.fetch, ts.ShardedVolume.crop
    real_gather = tsk._gather_crops_sharded

    def fetch(x):
        if x is not None:
            seen.append(int(np.prod(tuple(x.shape))))
        return real_fetch(x)

    def crop(self, index):
        out = real_crop(self, index)
        seen.append(int(out.numel()))
        return out

    def gather(*a, **k):
        out = real_gather(*a, **k)
        seen.extend(int(o[0].numel()) for o in out)
        return out

    monkeypatch.setattr(comm, "fetch", fetch)
    monkeypatch.setattr(ts.ShardedVolume, "crop", crop)
    monkeypatch.setattr(ts.ShardedVolume, "__getitem__", crop)
    monkeypatch.setattr(tsk, "_gather_crops_sharded", gather)
    # a soma detection threshold below every DBF max hands every label to
    # the crop engine
    teasar = dict(kimimaro_tpu_torch.DEFAULT_TEASAR_PARAMS,
                  soma_detection_threshold=0.5,
                  soma_acceptance_threshold=1e9)
    for params in (None, teasar):  # the sharded engine, the crop engine
        out = tskel(labels, mesh=_tmesh(4), anisotropy=(1, 1, 1),
                    dust_threshold=10, teasar_params=params)
        assert sorted(out) == [5, 6]
    assert seen, "no transfers recorded"
    assert max(seen) < labels.size // 2, max(seen)


def test_gather_crops_sharded_matches_slicing():
    n = 4
    rng = np.random.RandomState(3)
    vol = rng.randint(0, 50, size=(8 * n, 24, 16)).astype(np.int32)
    dbf = rng.rand(*vol.shape).astype(np.float32)
    tm = _tmesh(n)
    offs = np.array([[0, 0, 0], [4, 3, 2], [8 * n - 8, 16, 8], [7, 5, 1]],
                    dtype=np.int64)
    for vg in (None, vol.astype(np.uint32) * 3):
        comm.reset_exchanges()
        got = tsk._gather_crops_sharded(
            ts.shard_volume(vol, tm), ts.shard_volume(dbf, tm), offs, tm,
            (8, 8, 8), vg=None if vg is None else ts.shard_volume(vg, tm))
        assert len(got) == (2 if vg is None else 3)
        assert comm.EXCHANGES["crop"] == 1  # one gather for the batch
        for j, o in enumerate(offs):
            sl = tuple(slice(int(a), int(a + b)) for a, b in zip(o, (8,) * 3))
            np.testing.assert_array_equal(got[0][j].numpy(), vol[sl])
            _equal(got[1][j].numpy(), dbf[sl])
            if vg is not None:
                np.testing.assert_array_equal(
                    got[2][j].numpy().view(np.uint32), vg[sl])


@pytest.mark.parametrize("soma", (False, True), ids=("sharded_engine",
                                                      "crop_engine"))
def test_crop_gathers_are_batched(monkeypatch, soma):
    """Labels the sharded engine holds trace with no crop gather; labels
    it hands back (here soma-possible labels) ride one gather per crop-engine
    batch, not one per label."""
    calls = []
    real = tsk._gather_crops_sharded

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsk, "_gather_crops_sharded", spy)
    teasar = None
    if soma:
        teasar = dict(kimimaro_tpu_torch.DEFAULT_TEASAR_PARAMS,
                      soma_detection_threshold=0.5,
                      soma_acceptance_threshold=1e9)
    out = tskel(_six_bars(), mesh=_tmesh(4), anisotropy=(1, 1, 1),
                dust_threshold=10, teasar_params=teasar)
    assert sorted(out) == [1, 2, 3, 4, 5, 6]
    if soma:
        assert 1 <= len(calls) < 6, calls
    else:
        assert len(calls) == 0, calls


def test_parallel_exports_match_the_jax_package():
    import kimimaro_tpu.parallel as jp
    import kimimaro_tpu_torch.parallel as tp

    assert sorted(jp.__all__) == sorted(tp.__all__)
    assert not hasattr(kimimaro_tpu_torch, "parallel") or \
        "parallel" not in kimimaro_tpu_torch.__all__

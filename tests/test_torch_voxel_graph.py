"""The port under a voxel graph (self-touch walls, cc3d convention: bit
GRAPH_BITS[o] at v permits leaving v along o) against the JAX package on
the CPU, bit for bit: the CCL (on G1's CCL gate), the EDT's walls (3-D
and 2-D), the plain graph-gated B1 and B5, the host trace path's fields, the chase, the crop
engine, trace.trace and skeletonize as a whole (fix_borders and
fix_branching on and off, a label that reaches the host trace path, the
host stages, 2-D input), and the self-touch identity: walls that follow a
finer segmentation give the skeletons of that segmentation.

Graphs: random bit clears (asymmetric and symmetric), the wall graph of
tests/test_voxel_graph.py, and the connectivity graph of the labels
before touching labels were merged.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu import engine as jengine
from kimimaro_tpu import trace as jtrace
from kimimaro_tpu.ops import ccl as jccl
from kimimaro_tpu.ops import edt as jedt
from kimimaro_tpu.ops import fused_trace as jfused
from kimimaro_tpu.ops import geodesic as jgeo
from kimimaro_tpu_torch import engine as tengine
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.ops import ccl as tccl
from kimimaro_tpu_torch.ops import chase as tchase
from kimimaro_tpu_torch.ops import edt as tedt
from kimimaro_tpu_torch.ops import geodesic as tgeo
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops.stencils import GRAPH_BITS, graph_into
from kimimaro_tpu_torch.skeleton import Skeleton
from kimimaro_tpu_torch.utility import compute_cc_labels
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

ALL = (1 << 26) - 1
ANIS = (16.0, 16.0, 40.0)
TEASAR = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 1100,
          "soma_acceptance_threshold": 3500}


# --------------------------------------------------------------------------- #
# graphs and volumes


def wall_graph(shape, x_wall: int) -> np.ndarray:
    """All movement allowed except crossing the plane between x_wall - 1
    and x_wall (tests/test_voxel_graph.py's fixture)."""
    vg = np.full(shape, ALL, dtype=np.uint32)
    lo, hi = np.uint32(ALL), np.uint32(ALL)
    for o, b in GRAPH_BITS.items():
        if o[0] == 1:
            lo &= np.uint32(~(1 << b) & ALL)
        if o[0] == -1:
            hi &= np.uint32(~(1 << b) & ALL)
    vg[x_wall - 1] = lo
    vg[x_wall] = hi
    return vg


def _pairs(shape, o):
    """Slices (dst, src) with v in dst and v + o in src."""
    dst = tuple(slice(max(-c, 0), n + min(-c, 0)) for c, n in zip(o, shape))
    src = tuple(slice(max(c, 0), n + min(c, 0)) for c, n in zip(o, shape))
    return dst, src


def random_graph(shape, seed, p=0.3, symmetric=False) -> np.ndarray:
    """Every bit cleared with probability p; symmetric: an edge's two
    directions are cleared together."""
    rng = np.random.RandomState(seed)
    vg = np.full(shape, ALL, dtype=np.uint32)
    for o, b in GRAPH_BITS.items():
        if symmetric and o < tuple(-c for c in o):
            continue
        cut = rng.rand(*shape) < p
        vg[cut] &= np.uint32(~(1 << b) & ALL)
        if symmetric:
            dst, src = _pairs(shape, o)
            back = GRAPH_BITS[tuple(-c for c in o)]
            vg[src][cut[dst]] &= np.uint32(~(1 << back) & ALL)
    return vg


def label_graph(pre) -> np.ndarray:
    """cc3d's voxel_connectivity_graph of `pre`: bit GRAPH_BITS[o] at v set
    where v + o is in the volume and has v's label."""
    vg = np.zeros(pre.shape, dtype=np.uint32)
    for o, b in GRAPH_BITS.items():
        dst, src = _pairs(pre.shape, o)
        vg[dst] |= (pre[dst] == pre[src]).astype(np.uint32) << np.uint32(b)
    return vg


def blob_volume(seed, shape=(40, 36, 30), n_seeds=7):
    """Irregular blobs (tests/test_torch_skeletonize.py's fixture)."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, dtype=np.uint32)
    for lab in range(1, n_seeds + 1):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        m = (e + rng.rand(*shape) * 0.4) < 1.0
        vol[m & (vol == 0)] = lab
    return vol


def touching_pairs(pre):
    """(a, b) label pairs, a < b, that touch 26-connectedly."""
    pairs = set()
    for o in GRAPH_BITS:
        dst, src = _pairs(pre.shape, o)
        a, b = pre[dst], pre[src]
        m = (a != b) & (a != 0) & (b != 0)
        pairs.update(zip(np.minimum(a[m], b[m]).tolist(),
                         np.maximum(a[m], b[m]).tolist()))
    return sorted(pairs)


def self_touch(pre):
    """Merge some labels into a touching neighbour: (merged volume, its
    voxel graph (the pre-merge labels' connectivity), {pre label: merged
    label})."""
    merge = {}
    for a, b in touching_pairs(pre):
        if a not in merge and b not in merge:
            merge[b] = a
    lut = np.arange(int(pre.max()) + 1, dtype=pre.dtype)
    for b, a in merge.items():
        lut[b] = a
    return lut[pre], label_graph(pre), {int(k): int(lut[k])
                                        for k in np.unique(pre) if k}


# --------------------------------------------------------------------------- #
# CCL and EDT


GRAPHS = ("asym", "sym", "wall", "labels")


def _graph(kind, labels, seed):
    if kind == "asym":
        return random_graph(labels.shape, seed)
    if kind == "sym":
        return random_graph(labels.shape, seed, p=0.4, symmetric=True)
    if kind == "wall":
        return wall_graph(labels.shape, labels.shape[0] // 2)
    return label_graph(np.random.RandomState(seed).randint(
        0, 2, size=labels.shape))


def _labels(seed, shape=(11, 13, 9)):
    return np.random.RandomState(seed).randint(
        0, 3, size=shape).astype(np.uint32)


def test_symmetric_graph_is_symmetric():
    vg = random_graph((7, 8, 6), 0, p=0.4, symmetric=True)
    for o, b in GRAPH_BITS.items():
        dst, src = _pairs(vg.shape, o)
        back = GRAPH_BITS[tuple(-c for c in o)]
        np.testing.assert_array_equal((vg[dst] >> b) & 1,
                                      (vg[src] >> back) & 1)
    assert (vg != ALL).any()


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("seed", (0, 1))
def test_connected_components_matches_jax(kind, seed):
    labels = _labels(seed)
    vg = _graph(kind, labels, seed + 5)
    want = np.asarray(jccl.connected_components(labels, voxel_graph=vg))
    got = tccl.connected_components(torch.from_numpy(labels.view(np.int32)),
                                    torch.from_numpy(vg))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(jccl.connected_components(labels))
    assert len(np.unique(want)) > len(np.unique(plain))


def test_connected_components_pointer_jumps_keep_the_fixpoint(monkeypatch):
    """Pointer jumps from the first round on, with an asymmetric graph:
    the ids stay those of the voxels that reach each voxel, so the
    fixpoint is the JAX package's."""
    labels = np.ones((12, 10, 9), dtype=np.uint32)
    labels[:, 4] = 2
    vg = random_graph(labels.shape, 3, p=0.6)
    monkeypatch.setattr(tccl, "_PHASE1_ROUNDS", 0)
    want = np.asarray(jccl.connected_components(labels, voxel_graph=vg))
    got = tccl.connected_components(torch.from_numpy(labels.view(np.int32)),
                                    torch.from_numpy(vg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_compute_cc_labels_matches_jax():
    labels = _labels(4)
    vg = random_graph(labels.shape, 4, symmetric=True)
    want, wmap = kimimaro_tpu.utility.compute_cc_labels(labels,
                                                        voxel_graph=vg)
    got, gmap = compute_cc_labels(labels, voxel_graph=vg, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert gmap == wmap


@pytest.mark.parametrize("layout", (0, 1, 2))
@pytest.mark.parametrize("descending", (False, True))
def test_graph_gated_b1_plain_matches_jax_stage(layout, descending):
    """One directed graph-gated minid sweep of the plain B1 on a layout
    (B1-vg: the ids and G1's CCL gate, graph_into of the graph with the
    labels, bits of gsweep.gate_bits9) against the JAX package's
    `_ccl_stage` sweep of the same axis and direction, both from the same
    random ids."""
    rng = np.random.RandomState(layout + 3 * descending)
    labels = rng.randint(0, 3, size=(7, 9, 8)).astype(np.int32)
    vg = random_graph(labels.shape, 9 + layout)
    ids = np.where(labels != 0, rng.randint(1, 500, size=labels.shape),
                   2**31 - 1).astype(np.int32)
    perm = ((0, 1, 2), (1, 0, 2), (2, 0, 1))[layout]
    gate = graph_into(torch.from_numpy(vg), torch.from_numpy(labels))
    got = tgsweep.sweep0(
        torch.from_numpy(ids).permute(*perm).contiguous(), None, None, None,
        (1.0, 1.0, 1.0), "minid", False, descending,
        gate.permute(*perm).contiguous(),
        tgsweep.gate_bits9(layout, descending))
    got = got.permute(*np.argsort(perm)).numpy()
    # the JAX stage's sweep along the original axis perm[0]: one phase-1
    # round of that sweep alone
    axis, direction = perm[0], -1 if descending else 1
    want = _jax_ccl_sweep(ids, labels, vg, axis, direction)
    np.testing.assert_array_equal(got, want)


def _jax_ccl_sweep(ids, labels, vg, axis, direction):
    """kimimaro_tpu.ops.ccl._ccl_stage's `sweep` for one axis and
    direction (the stage's inner function, rebuilt from its parts)."""
    from kimimaro_tpu.ops.stencils import graph_allows, shifted

    offs = [o for o in jccl.OFFSETS26 if o[axis] == -direction]
    shifts = [(tuple(o[a] for a in range(3) if a != axis),
               tuple(-c for c in o)) for o in offs]
    ii = jnp.moveaxis(jnp.asarray(ids), axis, 0)
    ll = jnp.moveaxis(jnp.asarray(labels), axis, 0)
    gg = jnp.moveaxis(jnp.asarray(vg), axis, 0)
    if direction < 0:
        ii, ll, gg = ii[::-1], ll[::-1], gg[::-1]

    def step(carry, x):
        prev_i, prev_l = carry
        cur_i, cur_l, vgp = x
        best = cur_i
        for po, neg_o in shifts:
            nb_i = shifted(prev_i, po, jccl._BIGID)
            nb_l = shifted(prev_l, po, 0)
            ok = (nb_l == cur_l) & (nb_i < best)
            ok = ok & shifted(graph_allows(vgp, neg_o), po, False)
            best = jnp.where(ok, nb_i, best)
        return (best, cur_l), best

    _, rest = jax.lax.scan(step, (ii[0], ll[0]), (ii[1:], ll[1:], gg[:-1]))
    out = jnp.concatenate([ii[:1], rest], axis=0)
    if direction < 0:
        out = out[::-1]
    return np.asarray(jnp.moveaxis(out, 0, axis))


@pytest.mark.parametrize("kind", ("asym", "wall", "labels"))
@pytest.mark.parametrize("dims", (3, 2))
@pytest.mark.parametrize("black_border", (False, True))
def test_edt_walls_match_jax(kind, dims, black_border):
    labels = _labels(7, shape=(14, 12, 10))
    labels[labels == 2] = 1  # long runs, so that walls cut them
    vg = _graph(kind, labels, 8)
    anis = (4.0, 9.0, 2.5)
    if dims == 2:
        labels, vg, anis = labels[:, :, 3], vg[:, :, 3], anis[:2]
    want = np.asarray(jedt.edt(labels, anis, black_border, voxel_graph=vg))
    got = tedt.edt(torch.from_numpy(labels.astype(np.int32)), anis,
                   black_border, voxel_graph=torch.from_numpy(vg))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(jedt.edt(labels, anis, black_border))
    assert (want != plain).any()


# --------------------------------------------------------------------------- #
# the host trace path's sweeps and fields


def _crop(seed, shape=(11, 9, 13)):
    rng = np.random.RandomState(seed)
    ok = rng.rand(*shape) < 0.8
    vg = random_graph(shape, seed + 20, p=0.25)
    nc = np.where(ok, rng.rand(*shape) * 4 + 0.1, np.inf).astype(np.float32)
    src = tuple(int(c) for c in np.argwhere(ok)[len(np.argwhere(ok)) // 3])
    return ok, vg, nc, src, rng


@pytest.mark.parametrize("axis", (0, 1, 2))
@pytest.mark.parametrize("direction", (1, -1))
@pytest.mark.parametrize("mode", ("euclid", "node", "clamp"))
def test_graph_gated_b5_plain_matches_jax_sweep(axis, direction, mode):
    ok, vg, nc, _, rng = _crop(axis)
    dist = np.where(rng.rand(*ok.shape) < 0.2, rng.rand(*ok.shape) * 50,
                    np.inf).astype(np.float32)
    if mode == "clamp":
        dist = np.where(np.isfinite(dist), -dist, np.inf).astype(np.float32)
    node = nc if mode == "node" else None
    want = np.asarray(jgeo._sweep(
        jnp.asarray(dist), jnp.asarray(ok), None if node is None
        else jnp.asarray(node), axis, direction, ANIS, mode == "clamp",
        voxel_graph=jnp.asarray(vg), pallas=False))
    views = tgeo._SweptViews(torch.from_numpy(ok), None if node is None
                             else torch.from_numpy(node),
                             torch.from_numpy(vg))
    got = tgeo._sweep(torch.from_numpy(dist), views, axis, direction, ANIS,
                      mode == "clamp")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("field", ("euclid", "node", "parent_node",
                                   "parent_euclid", "ball"))
def test_fields_match_jax(field):
    ok, vg, nc, src, rng = _crop(5)
    ok_t, vg_t = torch.from_numpy(ok), torch.from_numpy(vg)
    if field in ("euclid", "parent_euclid"):
        want = np.asarray(jgeo.euclidean_distance_field(ok, src, ANIS,
                                                        voxel_graph=vg))
        got = tgeo.euclidean_distance_field(ok_t, src, ANIS,
                                            voxel_graph=vg_t)
        plain = np.asarray(jgeo.euclidean_distance_field(ok, src, ANIS))
        assert (plain != want).any()
        if field == "parent_euclid":
            want = np.asarray(jgeo.parent_field(want, ok, ANIS,
                                                voxel_graph=vg))
            got = tgeo.parent_field(got, ok_t, ANIS, voxel_graph=vg_t)
    elif field in ("node", "parent_node"):
        init = np.full(ok.shape, np.inf, dtype=np.float32)
        init[src] = 0.0
        want = np.asarray(jgeo.distance_field(ok, init, ANIS, node_cost=nc,
                                              voxel_graph=vg))
        got = tgeo.distance_field(ok_t, torch.from_numpy(init), ANIS,
                                  node_cost=torch.from_numpy(nc),
                                  voxel_graph=vg_t)
        if field == "parent_node":
            want = np.asarray(jgeo.parent_field(want, ok, ANIS, node_cost=nc,
                                                voxel_graph=vg))
            got = tgeo.parent_field(got, ok_t, ANIS,
                                    node_cost=torch.from_numpy(nc),
                                    voxel_graph=vg_t)
    else:
        dbf = np.where(ok, rng.rand(*ok.shape) * 60, 0).astype(np.float32)
        path = np.argwhere(ok)[::9][:5]
        want = np.asarray(jgeo.invalidation_ball(ok, dbf, path, 1.5, 20.0,
                                                 ANIS, voxel_graph=vg))
        got = tgeo.invalidation_ball(ok_t, torch.from_numpy(dbf), path, 1.5,
                                     20.0, ANIS, voxel_graph=vg_t)
        assert 0 < want.sum() < ok.sum()
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


def test_path_voxels_outside_the_crop_follow_jax_index_rule():
    """A chase that walked out of its crop (walled-off voxels) hands the
    eager loop path voxels outside the crop: its ball seeds and rail
    zeros index them by JAX's rule (negative once from the end; gathers
    clamp, scatters drop), as the JAX package's eager loop does."""
    ok, vg, nc, _, rng = _crop(6)
    dbf = np.where(ok, rng.rand(*ok.shape) * 60, 0).astype(np.float32)
    path = np.array([[3, 3, 3], [-1, 2, 3], [0, -2, 1], [-12, 1, 1],
                     [20, 1, 1], [2, 4, -13], [10, 8, 12]])
    want = np.asarray(jgeo.invalidation_ball(ok, dbf, path, 1.5, 20.0, ANIS,
                                             voxel_graph=vg))
    got = tgeo.invalidation_ball(torch.from_numpy(ok), torch.from_numpy(dbf),
                                 path, 1.5, 20.0, ANIS,
                                 voxel_graph=torch.from_numpy(vg))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jtrace._zero_at(jnp.asarray(nc), jnp.asarray(path)))
    got = ttrace._zero_at(torch.from_numpy(nc), path)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_relax_matches_jax_lanes():
    """relax_rounds_batched (plain B4 with per-lane graphs) against the
    JAX package's lane-batched relaxation under vmap, with the flags."""
    lanes = [_crop(s, shape=(9, 12, 7)) for s in (1, 2, 3)]
    ok = np.stack([c[0] for c in lanes])
    vg = np.stack([c[1] for c in lanes])
    nc = np.stack([c[2] for c in lanes])
    init = np.full(ok.shape, np.inf, dtype=np.float32)
    for b, c in enumerate(lanes):
        init[(b,) + c[3]] = 0.0
    for node, rounds in ((False, 1), (True, 6)):
        n_in = jnp.asarray(nc) if node else None
        want, wconv = jax.vmap(
            lambda d, o, n, v: jfused._relax_rounds(d, o, n, ANIS, rounds,
                                                   voxel_graph=v),
            in_axes=(0, 0, 0 if node else None, 0))(
                jnp.asarray(init), jnp.asarray(ok), n_in, jnp.asarray(vg))
        got, gconv = tgeo.relax_rounds_batched(
            torch.from_numpy(init), torch.from_numpy(ok),
            torch.from_numpy(nc) if node else None, ANIS, rounds,
            voxel_graph=torch.from_numpy(vg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gconv.numpy(), np.asarray(wconv))


def test_chase_matches_jax():
    """chase_batched and the host chase with a zero-padded graph against
    the JAX chase under vmap: equal paths, lengths and rail flags."""
    rng = np.random.RandomState(4)
    d = rng.randint(0, 6, size=(4, 9, 8, 7)).astype(np.float32)
    d[rng.rand(*d.shape) < 0.15] = np.inf
    vg = np.stack([random_graph(d.shape[1:], 30 + b, p=0.5)
                   for b in range(4)])
    d_pad = np.pad(d, ((0, 0), (1, 1), (1, 1), (1, 1)),
                   constant_values=np.inf)
    vg_pad = np.pad(vg, ((0, 0), (1, 1), (1, 1), (1, 1)))
    starts = np.array([[8, 7, 6], [0, 0, 0], [4, 2, 5], [5, 5, 2]])
    path, plen, reached = tchase.chase_batched(
        torch.from_numpy(d_pad), torch.from_numpy(starts), 12,
        torch.from_numpy(vg_pad))
    wp, wl, wr = jax.vmap(lambda dp, st, vp: jfused._chase(dp, st, 12, vp))(
        jnp.asarray(d_pad), jnp.asarray(starts, dtype=jnp.int32),
        jnp.asarray(vg_pad))
    np.testing.assert_array_equal(path.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(reached.numpy(), np.asarray(wr))
    for b in range(4):
        hp, hl, hr = tchase._chase(d_pad[b], starts[b], 12, vg_pad[b])
        assert hl == int(wl[b]) and hr == bool(wr[b])
        np.testing.assert_array_equal(hp, np.asarray(wp[b]))
    plain, _, _ = tchase.chase_batched(torch.from_numpy(d_pad),
                                       torch.from_numpy(starts), 12)
    assert not torch.equal(plain, path)


# --------------------------------------------------------------------------- #
# the crop engine, the host trace path and skeletonize


def _cc_dbf(labels, vg):
    """Both packages' intake of `labels` under `vg`: compact cc, DBF and a
    job per component."""
    cc = np.asarray(jccl.compact_cc(jccl.connected_components(
        labels, voxel_graph=vg))[0])
    dbf = np.asarray(jedt.edt(jnp.asarray(cc), ANIS, voxel_graph=vg))
    dbf = np.where(cc != 0, dbf, 0.0).astype(np.float32)
    jobs = []
    for segid in range(1, int(cc.max()) + 1):
        pts = np.argwhere(cc == segid)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        jobs.append({"segid": segid, "offset": mn.astype(np.int64),
                     "shape": (mx - mn + 1).astype(np.int64),
                     "before": [], "after": [], "root": None,
                     "count": len(pts),
                     "dbfmax": float(dbf[cc == segid].max())})
    return cc.astype(np.int32), dbf, jobs


@pytest.mark.parametrize("fix_branching", (True, False))
def test_trace_batched_matches_jax(fix_branching):
    pre = blob_volume(2)
    merged, vg, _ = self_touch(pre)
    cc, dbf, jobs = _cc_dbf(merged, vg)
    want, want_fb = jengine.trace_batched(
        jnp.asarray(cc), jnp.asarray(dbf), jobs, TEASAR, ANIS, fix_branching,
        voxel_graph=jnp.asarray(vg))
    got, got_fb = tengine.trace_batched(
        torch.from_numpy(cc), torch.from_numpy(dbf), jobs, TEASAR, ANIS,
        fix_branching, voxel_graph=torch.from_numpy(vg))
    assert sorted(j["segid"] for j in got_fb) == sorted(
        j["segid"] for j in want_fb)
    assert set(got) == set(want) and len(got) >= 5
    for segid in want:
        assert len(got[segid]) == len(want[segid])
        for (gv, gr), (wv, wr) in zip(got[segid], want[segid]):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gr, wr)


def _assert_same_skeleton(a, b):
    assert Skeleton.equivalent(a, b)
    ra = {tuple(v): r for v, r in zip(a.vertices.astype(int), a.radii)}
    for v, r in zip(b.vertices.astype(int), b.radii):
        assert ra[tuple(v)] == r


def l_tube():
    """An L-shaped tube that fills its (18, 18, 4) bounding box's arms."""
    labels = np.zeros((18, 18, 4), dtype=np.uint32)
    labels[:, 7:11] = 1
    labels[7:11, :] = 1
    return labels


@pytest.mark.parametrize("fix_branching", (True, False))
def test_trace_matches_jax_in_the_eager_loop(fix_branching, monkeypatch):
    """trace.trace under a graph never takes the fused loop: a wall
    through an L-shaped tube, equal to the JAX package's host loop."""
    def fused(*args, **kw):
        raise AssertionError("the fused loop ran under a voxel graph")

    monkeypatch.setattr(ttrace, "_compute_paths_fused", fused)
    labels = l_tube()
    vg = wall_graph(labels.shape, 13)
    dbf = np.asarray(jedt.edt(labels, ANIS, voxel_graph=vg))
    dbf = np.where(labels != 0, dbf, 0.0).astype(np.float32)
    want = jtrace.trace(labels, dbf, anisotropy=ANIS,
                        fix_branching=fix_branching, voxel_graph=vg, **TEASAR)
    got = ttrace.trace(labels, dbf, anisotropy=ANIS,
                       fix_branching=fix_branching, voxel_graph=vg,
                       device="cpu", **TEASAR)
    _assert_same_skeleton(want, got)


def test_trace_matches_jax_in_soma_mode():
    """A hollow ball with a neurite: refill and re-EDT with walls, soma
    root, root ball and culling."""
    n = 14
    g = np.indices((n, n, n)).transpose(1, 2, 3, 0)
    r2 = np.sum((g - 6) ** 2, axis=-1)
    labels = ((r2 <= 25) & (r2 > 2)).astype(np.uint8)
    labels[9:14, 5:8, 5:8] = 1
    vg = random_graph(labels.shape, 11, p=0.15, symmetric=True)
    params = dict(scale=1.5, const=2, pdrf_scale=100000, pdrf_exponent=4,
                  soma_detection_threshold=3, soma_acceptance_threshold=5,
                  soma_invalidation_scale=0.5, soma_invalidation_const=0)
    dbf = np.asarray(jedt.edt(labels, (1, 1, 1), voxel_graph=vg))
    dbf = np.where(labels != 0, dbf, 0.0).astype(np.float32)
    want = jtrace.trace(labels, dbf, anisotropy=(1, 1, 1), voxel_graph=vg,
                        **params)
    got = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1), voxel_graph=vg,
                       device="cpu", **params)
    _assert_same_skeleton(want, got)


def _run_both(vol, vg, teasar=TEASAR, **kw):
    kw = dict(teasar_params=teasar, anisotropy=ANIS, dust_threshold=10,
              voxel_graph=vg, **kw)
    want = kimimaro_tpu.skeletonize(vol.copy(), **kw)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.skeletonize(vol, device="cpu", **kw)
    finally:
        profiling.collect(False)
    assert set(got) == set(want) and len(got) >= 2
    for k in want:
        assert got[k].to_swc() == want[k].to_swc(), k
    return got, profiling.get_stats()["counters"]


@pytest.mark.parametrize("fix_borders", (True, False))
@pytest.mark.parametrize("fix_branching", (True, False))
def test_skeletonize_matches_jax(fix_borders, fix_branching):
    pre = blob_volume(1)
    merged, vg, merge = self_touch(pre)
    assert len(set(merge.values())) < len(merge)
    got, counters = _run_both(merged, vg, fix_borders=fix_borders,
                              fix_branching=fix_branching)
    assert counters.get("gengine_iterations", 0) == 0
    assert counters["crop_engine_jobs"] == len(merge)


def test_skeletonize_host_path_label_matches_jax():
    """A label given more than 16 manual targets: the crop engine hands
    it to the host trace path, with its crop of the graph (the L-tube of
    the trace test, so the JAX package compiles its loop once)."""
    pre = np.zeros((24, 24, 8), dtype=np.uint32)
    pre[3:21, 3:21, 2:6] = l_tube()
    pre[3:8, 12:16, 2:6][pre[3:8, 12:16, 2:6] == 0] = 2
    pre[15:21, 15:21, 2:6] = 3
    merged, vg, merge = self_touch(pre)
    assert merge[2] == 1 and merge[3] == 3
    pts = np.argwhere(pre == 1)[::7][:17]
    got, counters = _run_both(
        merged, vg, fix_borders=True,
        extra_targets_before=[tuple(int(c) for c in p) for p in pts])
    assert counters["fallback_jobs"] >= 1


def test_skeletonize_host_stages_match_jax():
    """fill_holes and fix_avocados under a graph (the avocado EDTs take
    it): a hollow ball whose shell touches a neighbour label, with walls
    from a finer segmentation that has no hole there."""
    pre = blob_volume(4, shape=(28, 26, 20), n_seeds=5)
    x, y, z = np.ogrid[:28, :26, :20]
    r2 = (x - 14) ** 2 + (y - 13) ** 2 + ((z - 10) * 1.2) ** 2
    pre[r2 <= 36] = 20
    vg = label_graph(pre)
    pre[r2 <= 3] = 0
    merged, _, _ = self_touch(pre)
    got, counters = _run_both(merged, vg, fix_borders=True,
                              fill_holes=True, fix_avocados=True)
    assert counters["fill_labels"] >= 1


@pytest.mark.parametrize("case", ("2d", "wide", "compressed"))
def test_skeletonize_input_forms_match_jax(case):
    """2-D input (the graph widened with a trailing axis), labels wider
    than 32 bits (renumbered first) and a CompressedLabelVolume (streamed
    slab by slab, the graph uploaded beside it)."""
    if case == "compressed":
        from kimimaro_tpu.carray import CompressedLabelVolume as JCLV
        from kimimaro_tpu_torch.carray import CompressedLabelVolume as TCLV

        merged, vg, _ = self_touch(blob_volume(5))
        kw = dict(teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
                  voxel_graph=vg)
        want = kimimaro_tpu.skeletonize(JCLV(merged, slab=8), **kw)
        got = kimimaro_tpu_torch.skeletonize(TCLV(merged, slab=8),
                                             device="cpu", **kw)
        assert set(got) == set(want) and len(got) >= 2
        for k in want:
            assert got[k].to_swc() == want[k].to_swc(), k
        return
    if case == "2d":
        pre = np.zeros((40, 36), dtype=np.uint32)
        pre[4:36, 10:16] = 1
        pre[4:36, 16:22] = 2
        pre[18:22, 22:34] = 2
        pre[4:30, 26:32] = 3
        merged, vg, _ = self_touch(pre[..., None])
        merged, vg = merged[..., 0], vg[..., 0]
    else:
        merged, vg, _ = self_touch(blob_volume(5))
        merged = merged.astype(np.uint64) * np.uint64(1 << 40)
    _run_both(merged, vg, fix_borders=True)


def test_self_touch_identity_on_both_packages():
    """Walls that follow the pre-merge labels cut nothing inside a
    component: skeletonize(merged, voxel_graph=its pre-merge graph) equals
    skeletonize(pre, voxel_graph=all ones) merged by the merge map, on the
    JAX package and on the port."""
    pre = blob_volume(6)
    merged, vg, merge = self_touch(pre)
    ones = np.full(pre.shape, ALL, dtype=np.uint32)
    kw = dict(teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
              fix_borders=True)
    for pkg, extra in ((kimimaro_tpu, {}),
                       (kimimaro_tpu_torch, {"device": "cpu"})):
        a = pkg.skeletonize(merged, voxel_graph=vg, **kw, **extra)
        b = pkg.skeletonize(pre, voxel_graph=ones, **kw, **extra)
        assert set(a) == {merge[k] for k in b} and len(a) < len(b)
        for m in a:
            # the pieces in the order of their first voxels, as the merged
            # run's components
            parts = sorted((k for k in b if merge[k] == m),
                           key=lambda k: np.flatnonzero(pre.ravel() == k)[0])
            skel = b[parts[0]]
            if len(parts) > 1:
                skel = type(skel).simple_merge(
                    [b[k] for k in parts]).consolidate()
            assert a[m].to_swc() == skel.to_swc(), (pkg.__name__, m)

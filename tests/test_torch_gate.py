"""The graph gate that B4 and B5 read at the target voxel, against the
voxel graph's source bitfields read at the neighbour (the JAX package's
form), bit for bit on the CPU.

The gate of a voxel v (ops.stencils.graph_into) holds, at bit
GRAPH_BITS[o], whether the move from u = v + o into v is open; a sweep
reads it through the bits of its layout and direction
(ops.gsweep.gate_bits9). The CCL's form of the gate (graph_into with the
labels) keeps a move only where u has v's label, and sets bit OCC_BIT
where v is occupied: checked against the graph's gate and the label
equality built apart, and B1-vg's plain version on it (the ids and that
word) against the sweep that read the labels beside the graph's gate. The source form reads bit sweep_bits9[k] of the
neighbour u's own bitfield (ops.geodesic.sweep_bits9). Checked here:
the plain B5 and B4 in both forms over all three layouts, both
directions, node and euclid, with and without clamp; lanes of unequal
extent padded to one shape, whose gates never read another lane; the
batched relaxation with its gate against the source form; and the gates
that the crop engine builds once per lane set and the host trace path
once per label against a build in every relaxation. The JAX package
holds the source form (tests/test_torch_kernels.py,
tests/test_torch_edges.py, tests/test_torch_voxel_graph.py)."""

import numpy as np
import pytest
import torch

import kimimaro_tpu_torch
from kimimaro_tpu_torch import engine as tengine
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.ops import edt as tedt
from kimimaro_tpu_torch.ops import geodesic as tgeo
from kimimaro_tpu_torch.ops import gsweep as tgsweep
from kimimaro_tpu_torch.ops import sweep as tsweep
from kimimaro_tpu_torch.ops.ccl import label_words
from kimimaro_tpu_torch.ops.gsweep import gate_bits9
from kimimaro_tpu_torch.ops.stencils import (GRAPH_BITS, OCC_BIT, graph_into,
                                             pad_const)
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)
ALL = (1 << 26) - 1
# each sweep layout of an (X, Y, Z) volume: the swept axis first, the
# other two in order
LAYOUTS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))
TEASAR = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 1100,
          "soma_acceptance_threshold": 3500}


def random_words(rng, shape, p=0.3):
    """A voxel graph as int32 words: each of the 26 bits cleared with
    probability p, and the bits above them random."""
    vg = rng.randint(0, 2**32, size=shape, dtype=np.uint64) \
        & ~np.uint64(ALL)
    for b in GRAPH_BITS.values():
        vg |= (rng.rand(*shape) >= p).astype(np.uint64) << np.uint64(b)
    return torch.from_numpy(vg.astype(np.uint32).view(np.int32))


def fields(rng, shape, clamp):
    d = np.where(rng.rand(*shape) < 0.25,
                 rng.rand(*shape) * 10 - (5.0 if clamp else 0.0), np.inf)
    ok = rng.rand(*shape) < 0.8
    nc = rng.rand(*shape) * 3 + 0.1
    return (torch.from_numpy(d.astype(np.float32)), torch.from_numpy(ok),
            torch.from_numpy(nc.astype(np.float32)))


def in_layout(t, layout, lanes=False):
    """A volume (or a (B, X, Y, Z) batch) moved into a sweep layout."""
    perm = LAYOUTS[layout]
    if lanes:
        perm = (0,) + tuple(1 + a for a in perm)
    return t.permute(*perm).contiguous()


def anis_of(layout):
    return tuple(ANIS[a] for a in LAYOUTS[layout])


CASES = [(layout, desc, node, clamp) for layout in (0, 1, 2)
         for desc in (False, True) for node in (False, True)
         for clamp in (False, True)]


@pytest.mark.parametrize("layout,desc,node,clamp", CASES)
def test_b5_gate_matches_source_bitfields(layout, desc, node, clamp):
    rng = np.random.RandomState(7 * layout + 2 * desc + node + 3 * clamp)
    shape = (9, 11, 7)
    vg = random_words(rng, shape)
    d, ok, nc = (in_layout(t, layout) for t in fields(rng, shape, clamp))
    vg_l = in_layout(vg, layout)
    gate_l = in_layout(graph_into(vg), layout)
    args = (d, ok, nc, anis_of(layout), node, clamp, desc)
    want = tsweep._sweep_axis0_plain(*args, vg=vg_l,
                                     bits9=tgeo.sweep_bits9(layout, desc))
    got = tsweep._sweep_axis0_plain(*args, gate=gate_l,
                                    gate_bits9=gate_bits9(layout, desc))
    assert torch.equal(got, want)
    # the wrapper: the main path's gate, and a gate it builds from vg
    assert torch.equal(tsweep.sweep_axis0(
        *args, gate=gate_l, gate_bits9=gate_bits9(layout, desc)), want)
    assert torch.equal(tsweep.sweep_axis0(
        *args, vg=vg_l.view(torch.uint32),
        bits9=tgeo.sweep_bits9(layout, desc)), want)
    first = -1 if desc else 0
    assert torch.equal(got[first], d[first])
    # the gate closes moves: the ungated sweep differs (a clamped euclid
    # sweep keeps no candidate, every step cost being positive)
    if node or not clamp:
        assert not torch.equal(tsweep._sweep_axis0_plain(*args), want)


# lanes of unequal extent in one (X, Y, Z) bucket; the rest of a lane is
# padding with random graph words and an ok mask, as a crop's surroundings
BUCKET = (9, 10, 7)
EXTENTS = ((9, 10, 7), (5, 8, 4), (9, 3, 7), (2, 10, 6))


def lanes(rng, clamp):
    B = len(EXTENTS)
    vg = random_words(rng, (B,) + BUCKET, p=0.1)
    d, ok, nc = fields(rng, (B,) + BUCKET, clamp)
    for b, e in enumerate(EXTENTS):
        inner = (b,) + tuple(slice(0, s) for s in e)
        vg[inner] = random_words(rng, e)
    return vg, d, ok, nc


@pytest.mark.parametrize("layout,desc,node,clamp", CASES)
def test_b4_lane_gates_match_source_bitfields(layout, desc, node, clamp):
    rng = np.random.RandomState(50 + 7 * layout + 2 * desc + node
                                + 3 * clamp)
    vg, d, ok, nc = lanes(rng, clamp)
    gate = graph_into(vg)
    # a lane's gate is its own graph's: no bit reads another lane
    for b in range(len(EXTENTS)):
        assert torch.equal(gate[b], graph_into(vg[b]))
    vg_l, gate_l, d, ok, nc = (in_layout(t, layout, lanes=True)
                               for t in (vg, gate, d, ok, nc))
    args = (d, ok, nc, anis_of(layout), node, clamp, desc)
    sb, gb = tgeo.sweep_bits9(layout, desc), gate_bits9(layout, desc)
    want = tsweep._sweep_axis0_batched_plain(*args, vg=vg_l, bits9=sb)
    for b in range(len(EXTENTS)):
        lane = tsweep._sweep_axis0_plain(
            d[b], ok[b], nc[b], anis_of(layout), node, clamp, desc,
            vg=vg_l[b], bits9=sb)
        assert torch.equal(want[b], lane)
    assert torch.equal(tsweep._sweep_axis0_batched_plain(
        *args, gate=gate_l, gate_bits9=gb), want)
    assert torch.equal(tsweep.sweep_axis0_batched(
        *args, gate=gate_l, gate_bits9=gb), want)
    assert torch.equal(tsweep.sweep_axis0_batched(*args, vg=vg_l, bits9=sb),
                       want)


def source_relax(d, ok, nc, rounds, vg):
    """rounds + 1 rounds of the six sweeps on B4's plain version in the
    source form: the relaxation before its gate was built."""
    for _ in range(rounds + 1):
        for a in range(3):
            dm = in_layout(d, a, lanes=True)
            args = (in_layout(ok, a, lanes=True),
                    None if nc is None else in_layout(nc, a, lanes=True),
                    anis_of(a), nc is not None, False)
            for desc in (False, True):
                dm = tsweep._sweep_axis0_batched_plain(
                    dm, *args, desc, vg=in_layout(vg, a, lanes=True),
                    bits9=tgeo.sweep_bits9(a, desc))
            inv = tuple(int(i) for i in np.argsort(
                (0,) + tuple(1 + c for c in LAYOUTS[a])))
            d = dm.permute(*inv).contiguous()
    return d


@pytest.mark.parametrize("node", (False, True))
def test_relax_rounds_batched_gate_matches_source_bitfields(node):
    rng = np.random.RandomState(90 + node)
    vg, _, ok, nc = lanes(rng, False)
    init = torch.full(ok.shape, float("inf"))
    for b in range(len(EXTENTS)):
        init[b, 0, 0, 0] = 0.0
        ok[b, 0, 0, 0] = True
    nc = nc if node else None
    want = source_relax(init, ok, nc, 2, vg)
    for kw in ({"gate": graph_into(vg)}, {"voxel_graph": vg}):
        got, conv = tgeo.relax_rounds_batched(init, ok, nc, ANIS, 2, **kw)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tgeo.relax_rounds_batched(init, ok, nc, ANIS, 2, voxel_graph=vg,
                                  gate=graph_into(vg))


# --------------------------------------------------------------------------- #
# the CCL's gate: label equality and occupancy folded into the word


def same_label_bits(labels):
    """numpy: bit GRAPH_BITS[o] at v where v + o lies in the volume (the
    last three axes) and has v's label, and v's label is not 0."""
    lead = labels.ndim - 3
    out = np.zeros(labels.shape, dtype=np.int64)
    for o, b in GRAPH_BITS.items():
        dst, src = _pairs(labels.shape[lead:], o)
        dst, src = (slice(None),) * lead + dst, (slice(None),) * lead + src
        same = (labels[dst] == labels[src]) & (labels[dst] != 0)
        out[dst] |= same.astype(np.int64) << b
    return out


# (shape, label values (0 among them), dtype): lanes, odd and one-voxel
# shapes, raw labels that bitcast to negative words, 64-bit labels that
# agree modulo 2^32 or are multiples of it (label_words renumbers them)
CCL_GATE_CASES = (
    ((9, 11, 7), (0, 5), np.int32),
    ((5, 6, 4), (0, 1, 2**31 + 3, 2**32 - 1, 7), np.uint32),
    ((3, 7, 5, 6), (0, 2, 9), np.int32),
    ((1, 1, 1), (0, 4), np.int32),
    ((1, 9, 1), (0, 1, 2, 3), np.uint8),
    ((2, 1, 1, 13), (0, 3, 4), np.uint16),
    ((7, 5, 9), (0, 2**33, 2**33 + 1, 1), np.int64),
    ((2, 2, 3, 4, 5), (0, 6, 2**40 + 6), np.uint64),
)


@pytest.mark.parametrize("case", range(len(CCL_GATE_CASES)))
def test_ccl_gate_is_the_graph_gate_and_the_label_equality(case):
    shape, values, dtype = CCL_GATE_CASES[case]
    rng = np.random.RandomState(120 + case)
    vg = random_words(rng, shape, p=0.2)
    labels = np.asarray(values, dtype=dtype)[
        rng.randint(0, len(values), size=shape)]
    got = graph_into(vg, label_words(labels)).numpy().astype(np.int64)
    want = (graph_into(vg).numpy().astype(np.int64)
            & same_label_bits(labels)) \
        | np.where(labels != 0, 1 << OCC_BIT, 0)
    np.testing.assert_array_equal(got, want)
    if len(shape) == 4:  # a lane's gate is its own volume's
        np.testing.assert_array_equal(
            graph_into(vg[-1], label_words(labels[-1])).numpy(), got[-1])
    with pytest.raises(ValueError):
        graph_into(vg, torch.from_numpy(labels.astype(np.int64)))


def cc_form_sweep(d, cc, gate, bits9, descending):
    """B1-vg's minid sweep as it ran before the gate held the labels: cc
    (raw labels as int32 words) beside the graph's gate, a neighbour of
    the previous plane counting where its carried id (its label where it
    is occupied, -1 elsewhere) equals the voxel's label and the gate's
    bit is set."""
    n, H, W = d.shape
    fill = 2**31 - 1
    occ = cc != 0
    cc_eff = torch.where(occ, cc, -1)
    out = torch.empty_like(d)
    prev_v = prev_c = None
    for p in (range(n - 1, -1, -1) if descending else range(n)):
        if prev_v is None:
            new = torch.where(occ[p], d[p], fill)
        else:
            pv, pc = pad_const(prev_v, 1, fill), pad_const(prev_c, 1, -1)
            cand = torch.full_like(d[p], fill)
            k = 0
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    at = (slice(1 + dy, 1 + dy + H), slice(1 + dz, 1 + dz + W))
                    same = (pc[at] == cc[p]) & \
                        (((gate[p] >> bits9[k]) & 1) > 0)
                    cand = torch.minimum(cand, torch.where(same, pv[at],
                                                           fill))
                    k += 1
            new = torch.where(occ[p], torch.minimum(d[p], cand), fill)
        out[p] = new
        prev_v, prev_c = new, cc_eff[p]
    return out


@pytest.mark.parametrize("layout", (0, 1, 2))
@pytest.mark.parametrize("desc", (False, True))
def test_b1_on_the_ccl_gate_matches_the_cc_form(layout, desc):
    """B1-vg's plain version on (ids, the CCL gate) against the sweep that
    read cc beside the graph's gate, and the wrapper on the CPU; ids at
    background and raw labels of -1 (an unoccupied neighbour's carried id
    in the cc form) included."""
    rng = np.random.RandomState(140 + 2 * layout + desc)
    shape = (9, 11, 7)
    vg = random_words(rng, shape, p=0.25)
    labels = torch.from_numpy(np.array([0, 3, -1, -7], dtype=np.int32)[
        rng.randint(0, 4, size=shape)])
    ids = torch.from_numpy(rng.randint(1, 999, size=shape).astype(np.int32))
    bits = gate_bits9(layout, desc)
    d, cc, gate, ccl_gate = (in_layout(t, layout) for t in (
        ids, labels, graph_into(vg), graph_into(vg, labels)))
    want = cc_form_sweep(d, cc, gate, bits, desc)
    got = tgsweep._sweep0_gate_plain(d, ccl_gate, bits, desc)
    assert torch.equal(got, want)
    assert torch.equal(tgsweep.sweep0(d, None, None, None, anis_of(layout),
                                      "minid", False, desc, ccl_gate, bits),
                       want)
    # the gate carries the labels: cc beside it is refused
    with pytest.raises(ValueError):
        tgsweep.sweep0(d, cc, None, None, anis_of(layout), "minid", False,
                       desc, ccl_gate, bits)


# --------------------------------------------------------------------------- #
# the gates built once (per lane set, per label) against a build in every
# relaxation


def _pairs(shape, o):
    dst = tuple(slice(max(-c, 0), n + min(-c, 0)) for c, n in zip(o, shape))
    src = tuple(slice(max(c, 0), n + min(c, 0)) for c, n in zip(o, shape))
    return dst, src


def label_graph(pre):
    """cc3d's voxel_connectivity_graph of `pre`."""
    vg = np.zeros(pre.shape, dtype=np.uint32)
    for o, b in GRAPH_BITS.items():
        dst, src = _pairs(pre.shape, o)
        vg[dst] |= (pre[dst] == pre[src]).astype(np.uint32) << np.uint32(b)
    return vg


def self_touch_volume():
    """Blobs, a bent tube and a block, with blob 2 merged into blob 1 and
    the block into the tube under the pre-merge graph; the tube gets 17
    manual targets (more than the crop engine holds: the host trace
    path). Returns (merged, graph, targets)."""
    rng = np.random.RandomState(3)
    pre = np.zeros((36, 34, 14), dtype=np.uint32)
    x, y, z = np.ogrid[:36, :34, :14]
    for lab in range(1, 6):
        c = rng.randint(5, np.array(pre.shape) - 5)
        r = rng.randint(3, 6, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
             + ((z - c[2]) / min(r[2], 4)) ** 2)
        pre[((e + rng.rand(*pre.shape) * 0.4) < 1.0) & (pre == 0)] = lab
    pre[4:30, 3:8, 3:8] = 7
    pre[24:30, 3:30, 3:8] = 7
    pre[24:30, 30:34, 3:8] = 8
    vg = label_graph(pre)
    merged = np.where(pre == 2, 1, np.where(pre == 8, 7, pre))
    pts = np.argwhere(pre == 7)
    pts = [tuple(int(c) for c in p) for p in pts[::len(pts) // 17][:17]]
    return merged.astype(np.uint32), vg, pts


def _count(monkeypatch, module, counts, key):
    inner = module.graph_into

    def spy(vg):
        counts[key] += 1
        return inner(vg)

    monkeypatch.setattr(module, "graph_into", spy)


def _build_per_call(monkeypatch):
    """The engine and trace.trace without their prebuilt gates: every
    relaxation and every field builds the gate from the graph itself."""
    monkeypatch.setattr(tengine, "graph_into", lambda vg: vg)
    inner = tengine.relax_rounds_batched

    def relax(*args, gate=None, **kw):
        return inner(*args, voxel_graph=gate, **kw)

    monkeypatch.setattr(tengine, "relax_rounds_batched", relax)
    monkeypatch.setattr(ttrace, "SweepGate", lambda vg: vg)


@pytest.mark.parametrize("fix_branching", (True, False))
def test_prebuilt_gates_match_a_build_per_relaxation(monkeypatch,
                                                     fix_branching):
    """skeletonize under a graph: the crop engine's gate, built once per
    lane set, and the host trace path's, once per label, give the
    skeletons of a gate built in every relaxation and field."""
    vol, vg, pts = self_touch_volume()
    kw = dict(teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=10,
              fix_branching=fix_branching, voxel_graph=vg,
              extra_targets_before=pts, device="cpu")
    out, builds = {}, {}
    for per_call in (False, True):
        with monkeypatch.context() as m:
            counts = {"engine": 0, "fields": 0}
            _count(m, tgeo, counts, "fields")
            _count(m, tengine, counts, "engine")
            if per_call:
                _build_per_call(m)
            profiling.reset_stats()
            profiling.collect(True)
            try:
                out[per_call] = kimimaro_tpu_torch.skeletonize(vol, **kw)
            finally:
                profiling.collect(False)
            counters = profiling.get_stats()["counters"]
            builds[per_call] = counts
        assert counters["crop_engine_jobs"] >= 4
        assert counters["fallback_jobs"] >= 1
    assert set(out[True]) == set(out[False]) and len(out[False]) >= 4
    for k in out[False]:
        assert out[False][k].to_swc() == out[True][k].to_swc(), k
    # prebuilt: one gate a lane set (the engine) and a label (the host
    # path's SweepGate); per call: one in every relaxation and field
    assert builds[False]["engine"] >= 1
    assert 1 <= builds[False]["fields"] <= counters["fallback_jobs"]
    assert builds[True]["fields"] > 10 * sum(builds[False].values())


def test_trace_soma_prebuilt_gate_matches_a_build_per_field(monkeypatch):
    """trace.trace in soma mode under a graph (refill and re-EDT with
    walls, the root ball, the path balls): its SweepGate against a gate
    built in every field."""
    n = 14
    g = np.indices((n, n, n)).transpose(1, 2, 3, 0)
    r2 = np.sum((g - 6) ** 2, axis=-1)
    labels = ((r2 <= 25) & (r2 > 2)).astype(np.uint8)
    labels[9:14, 5:8, 5:8] = 1
    vg = random_words(np.random.RandomState(11), labels.shape, p=0.15)
    vg = vg.view(torch.uint32).numpy()
    dbf = tedt.edt(labels, (1, 1, 1), voxel_graph=vg, device="cpu").numpy()
    dbf = np.where(labels != 0, dbf, 0.0).astype(np.float32)
    params = dict(scale=1.5, const=2, pdrf_scale=100000, pdrf_exponent=4,
                  soma_detection_threshold=3, soma_acceptance_threshold=5,
                  soma_invalidation_scale=0.5, soma_invalidation_const=0)
    want = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1), voxel_graph=vg,
                        device="cpu", **params)
    with monkeypatch.context() as m:
        m.setattr(ttrace, "SweepGate", lambda words: words)
        got = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1),
                           voxel_graph=vg, device="cpu", **params)
    assert len(want.vertices) > 3
    assert got.to_swc() == want.to_swc()

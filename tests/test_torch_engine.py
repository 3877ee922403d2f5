"""The port's crop engine (kimimaro_tpu_torch.engine.trace_batched)
against kimimaro_tpu.engine.trace_batched on the same cc / DBF volumes and
jobs: equal paths, radii and fallback sets. Also the port's crop engine
against the port's host trace path (the equality chain of
tests/test_soma_and_engine.py)."""

import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp
import torch

from kimimaro_tpu import engine as jengine
from kimimaro_tpu.ops import edt as jedt
from kimimaro_tpu_torch import engine as tengine
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.skeleton import Skeleton
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)
TEASAR = {
    "scale": 1.5,
    "const": 30,
    "pdrf_exponent": 4,
    "pdrf_scale": 100000,
    "soma_detection_threshold": 80,
    "soma_acceptance_threshold": 100,
    "soma_invalidation_scale": 0.5,
    "soma_invalidation_const": 0,
}


def _ball(shape, center, r2):
    g = np.indices(shape).transpose(1, 2, 3, 0)
    return np.sum((g - np.asarray(center)) ** 2, axis=-1) <= r2


def _volume():
    """Labels of several kinds in one (36, 32, 16) volume: a solid ball
    and a hollow one (soma mode, refill), an L-shaped tube, a bent tube
    and a small blob (below the soma cut)."""
    shape = (36, 32, 16)
    vol = np.zeros(shape, dtype=np.uint32)
    vol[_ball(shape, (9, 9, 8), 40)] = 1
    hollow = _ball(shape, (26, 9, 8), 36) & ~_ball(shape, (26, 9, 8), 2)
    vol[hollow] = 2
    vol[2:34, 20:23, 3:6] = 3
    vol[16:19, 17:31, 3:6] = 3
    for x in range(4, 32):
        y = 26 + int(round(3 * np.sin(x / 4.0)))
        vol[x, y:y + 2, 9:12] = 4
    vol[30:34, 27:31, 12:15] = 5
    return vol


def _inputs(vol):
    """cc (26-connected components of each label), the DBF and one job
    per component, as kimimaro_tpu's intake builds them."""
    cc = np.zeros(vol.shape, dtype=np.int32)
    n = 0
    for lab in np.unique(vol[vol > 0]):
        comp, k = ndimage.label(vol == lab, structure=np.ones((3, 3, 3)))
        cc[comp > 0] = comp[comp > 0] + n
        n += k
    dbf = np.asarray(jedt.edt(jnp.asarray(cc), anisotropy=ANIS,
                              black_border=False))
    dbf = np.where(cc != 0, dbf, 0.0).astype(np.float32)
    jobs = []
    for segid in range(1, n + 1):
        pts = np.argwhere(cc == segid)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        jobs.append({"segid": segid, "offset": mn.astype(np.int64),
                     "shape": (mx - mn + 1).astype(np.int64),
                     "before": [], "after": [], "root": None,
                     "count": len(pts),
                     "dbfmax": float(dbf[cc == segid].max())})
    return cc, dbf, jobs


def _point_in(cc, job, k):
    """The k-th voxel (in scan order) of the job's label, in bbox frame."""
    pts = np.argwhere(cc == job["segid"]) - job["offset"]
    return tuple(int(c) for c in pts[(k * 7) % len(pts)])


def _run_both(cc, dbf, jobs, teasar, fix_branching, monkeypatch=None,
              jax_only_batches=0):
    """Both engines on the same inputs: equal fallback sets and equal
    paths and radii. With `monkeypatch`, every batch's raw lane outputs
    (paths, lengths, path counts, overflow and non-convergence flags,
    radii) are compared too, so that labels the host gate sends back are
    held equal as well; the JAX engine's last `jax_only_batches` batches
    are re-runs that the port skips."""
    lanes = {"jax": [], "torch": []}
    if monkeypatch is not None:
        from kimimaro_tpu.utils import progcache

        def record_jax(name, fn, statics, *args, **kw):
            out = fn(*args, **statics)
            lanes["jax"].append([np.asarray(o) for o in out])
            return out

        def record_torch(*args, **kw):
            out = trace_lanes(*args, **kw)
            lanes["torch"].append([o.numpy() for o in out])
            return out

        trace_lanes = tengine._trace_lanes
        monkeypatch.setattr(progcache, "call", record_jax)
        monkeypatch.setattr(tengine, "_trace_lanes", record_torch)
    want, want_fb = jengine.trace_batched(
        jnp.asarray(cc), jnp.asarray(dbf), jobs, teasar, ANIS, fix_branching)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got, got_fb = tengine.trace_batched(
            torch.from_numpy(cc), torch.from_numpy(dbf), jobs, teasar, ANIS,
            fix_branching)
    finally:
        profiling.collect(False)
    assert len(lanes["jax"]) == len(lanes["torch"]) + jax_only_batches
    for w_out, g_out in zip(lanes["jax"], lanes["torch"]):
        B = len(g_out[0])  # the JAX engine pads a batch to a power of two
        for w, g in zip(w_out, g_out):
            np.testing.assert_array_equal(g, w[:B])
    assert sorted(j["segid"] for j in got_fb) == sorted(
        j["segid"] for j in want_fb)
    assert set(got) == set(want)
    for segid in want:
        assert len(got[segid]) == len(want[segid]), segid
        for (gv, gr), (wv, wr) in zip(got[segid], want[segid]):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gr, wr)
    return got, got_fb, profiling.get_stats()["counters"]


@pytest.mark.parametrize("case", ("soma", "no_soma", "fix_branching_false"))
def test_trace_batched_matches_jax(case, monkeypatch):
    """soma: soma candidates (refill, re-EDT, soma root and root ball,
    culling, a user root in soma mode) beside non-soma labels with manual
    targets and a label with more than T_CAP targets (host fallback). The
    soma label's culled paths have gaps, so both engines' structural gate
    sends it to the host path: its raw lane outputs are compared.
    no_soma: thresholds no label reaches (the soma branches left out).
    fix_branching_false: no rail re-relax, and a max_paths cap."""
    vol = _volume()
    cc, dbf, jobs = _inputs(vol)
    teasar, fix_branching = dict(TEASAR), True
    by_seg = {j["segid"]: j for j in jobs}
    if case == "soma":
        # the hollow ball (label 2) passes the detection threshold: its
        # cavity is refilled and its DBF recomputed, below acceptance
        teasar["soma_detection_threshold"] = 70
        by_seg[1]["root"] = _point_in(cc, by_seg[1], 3)
        by_seg[3]["before"] = [_point_in(cc, by_seg[3], k) for k in range(3)]
        by_seg[3]["after"] = [_point_in(cc, by_seg[3], 5)]
        by_seg[3]["root"] = _point_in(cc, by_seg[3], 9)
        by_seg[4]["before"] = [_point_in(cc, by_seg[4], k)
                               for k in range(tengine.T_CAP + 1)]
    elif case == "no_soma":
        teasar.update(soma_detection_threshold=1e9,
                      soma_acceptance_threshold=1e9)
    else:
        teasar.update(soma_detection_threshold=1e9,
                      soma_acceptance_threshold=1e9, max_paths=2)
        fix_branching = False
    got, fallback, _ = _run_both(cc, dbf, jobs, teasar, fix_branching,
                                 monkeypatch)
    if case == "soma":
        assert sorted(j["segid"] for j in fallback) == [1, 4]
        assert len(got) == 3
    else:
        assert not fallback
        assert len(got) == 5


def test_trace_batched_sends_a_soma_thicker_than_the_band_to_the_host(
        monkeypatch):
    """With a re-EDT band of 4 the refilled ball's distances do not fit.
    The JAX engine flags it on every rung of the escalation ladder and
    falls back; its refill converged, so more rounds cannot change the
    re-EDT, and the port falls back at once: the same fallback set, with
    no re-run (the JAX band set through KIMIMARO_TPU_EDT_BAND; the volume
    shape is unique so that no other test's compiled kernel is reused)."""
    shape = (23, 22, 21)
    vol = _ball(shape, (11, 11, 10), 81).astype(np.uint32)
    vol[11, 11, 10] = 0  # an interior hole: the refill takes
    cc, dbf, jobs = _inputs(vol)
    teasar = dict(TEASAR, soma_detection_threshold=5,
                  soma_acceptance_threshold=10)
    monkeypatch.setenv("KIMIMARO_TPU_EDT_BAND", "4")
    monkeypatch.setattr(tengine, "EDT_BAND_CAP", 4)
    got, fallback, counters = _run_both(cc, dbf, jobs, teasar, True,
                                        monkeypatch, jax_only_batches=2)
    assert not got
    assert [j["segid"] for j in fallback] == [1]
    assert counters["relax_retries"] == 0


def test_trace_batched_escalates_unconverged_lanes(monkeypatch):
    """With one sweep round per relax, two labels' fields do not
    converge: their lanes re-run on the ladder's x2 rung and are traced
    there, beside the labels that converge at once, in both engines
    alike (every batch's raw lane outputs compared, rung by rung)."""
    cc, dbf, jobs = _inputs(_volume())
    teasar = dict(TEASAR, soma_detection_threshold=1e9,
                  soma_acceptance_threshold=1e9)
    monkeypatch.setattr(jengine, "RELAX_ROUNDS", 1)
    monkeypatch.setattr(tengine, "RELAX_ROUNDS", 1)
    got, fallback, counters = _run_both(cc, dbf, jobs, teasar, True,
                                        monkeypatch)
    assert not fallback
    assert sorted(got) == [1, 2, 3, 4, 5]
    assert counters["relax_retries"] == 2


@pytest.mark.parametrize("rounds", (0, 3))
def test_crop_fill_and_banded_edt_match_jax(rounds, monkeypatch):
    """The refill helpers per lane against the JAX engine's under vmap:
    the segmented-scan flood gives the distance-sweep flood's filled
    voxels and stall flags, and the banded re-EDT its values and
    exactness flags (a band of 3 truncates the thicker lanes)."""
    import jax

    rng = np.random.RandomState(5)
    fg = rng.rand(4, 9, 8, 7) < 0.55
    fg[0] = _ball((9, 8, 7), (4, 4, 3), 9) & ~_ball((9, 8, 7), (4, 4, 3), 1)
    fg[1] = True
    bb = np.array([False, True, False, True])
    want_f, want_c = jax.vmap(lambda f: jengine._crop_fill(f, ANIS, rounds))(
        jnp.asarray(fg))
    got_f, got_c = tengine._crop_fill(torch.from_numpy(fg), rounds)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert not got_c.all() or rounds > 0

    monkeypatch.setattr(tengine, "EDT_BAND_CAP", 3)
    lab = np.asarray(want_f).astype(np.uint8)
    want_d, want_x = jax.vmap(lambda l, b: jengine._crop_edtsq_banded(
        l, ANIS, b, band_cap=3))(jnp.asarray(lab), jnp.asarray(bb))
    got_d, got_x = tengine._crop_edtsq_banded(
        torch.from_numpy(lab), ANIS, torch.from_numpy(bb))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    assert not got_x.all()


@pytest.mark.parametrize("fix_branching", (True, False))
def test_crop_engine_matches_host_trace(fix_branching):
    """The port's own equality chain: the crop engine's skeleton equals
    the host trace path's, radii included."""
    labels = np.zeros((40, 40, 8), dtype=np.int32)
    labels[4:36, 18:22, 2:6] = 1
    labels[18:22, 4:36, 2:6] = 1
    params = dict(scale=1.5, const=4, pdrf_scale=100000, pdrf_exponent=4,
                  soma_detection_threshold=1100,
                  soma_acceptance_threshold=3500)
    dbf = np.asarray(jedt.edt(labels, (1, 1, 1)))
    dbf = np.where(labels != 0, dbf, 0.0).astype(np.float32)
    host = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1),
                        fix_branching=fix_branching, device="cpu", **params)
    jobs = [{"segid": 1, "offset": np.zeros(3, dtype=np.int64),
             "shape": np.array(labels.shape, dtype=np.int64),
             "before": [], "after": [], "root": None}]
    results, fallback = tengine.trace_batched(
        torch.from_numpy(labels), torch.from_numpy(dbf), jobs, params,
        (1, 1, 1), fix_branching)
    assert not fallback
    eng = tengine.paths_to_skeleton(results[1], (1, 1, 1))
    assert Skeleton.equivalent(host, eng)
    hv = {tuple(v): r for v, r in zip(host.vertices.astype(int), host.radii)}
    for v, r in zip(eng.vertices.astype(int), eng.radii):
        assert hv[tuple(v)] == r


def _chase_lanes():
    """Rail fields of five lanes, padded by one +inf voxel, and a start
    per lane. Lane 3 has no rail: it walks out of the crop over +inf.
    Lane 4 starts in an all-+inf corner, leaves the crop there, and its
    wrapped window and reads (JAX's index rule) then find finite values
    and a rail at the crop's far corner."""
    rng = np.random.RandomState(3)
    d = rng.randint(0, 6, size=(5, 9, 8, 7)).astype(np.float32)
    d[rng.rand(*d.shape) < 0.2] = np.inf
    d[3] = np.inf  # no rail
    d[3, 4, 4, 3] = 5.0
    d[4] = np.inf
    d[4, -2:, -2:, -2:] = 2.0
    d[4, -2, -2, -2] = 1.0
    d[4, -1, -1, -1] = 0.0
    d_pad = np.pad(d, ((0, 0), (1, 1), (1, 1), (1, 1)),
                   constant_values=np.inf)
    starts = np.array([[8, 7, 6], [0, 0, 0], [4, 2, 5], [4, 4, 3],
                       [0, 0, 0]])
    return d_pad, starts


def test_lane_batched_chase_matches_host_chase():
    """chase_batched walks every lane as the host `_chase` walks one:
    first minimum in offset order, rails at d <= 0, a lane that cannot
    reach a rail runs to the buffer's end, and lane 4's walk outside the
    crop follows the same wrapped indices."""
    from kimimaro_tpu_torch.ops.chase import _chase, chase_batched

    d_pad, starts = _chase_lanes()
    path, plen, reached = chase_batched(torch.from_numpy(d_pad),
                                        torch.from_numpy(starts), 12)
    for b in range(5):
        wp, wl, wr = _chase(d_pad[b], starts[b], 12)
        assert int(plen[b]) == wl and bool(reached[b]) == wr
        np.testing.assert_array_equal(path[b, :wl].numpy(), wp[:wl])
    assert not bool(reached[3])


def test_lane_batched_chase_matches_jax_chase():
    """chase_batched against the JAX crop engine's chase under vmap on
    the same padded fields and starts: equal paths, lengths and rail
    flags, lane 4's walk outside the crop included (it reaches the rail
    only through the wrapped indices)."""
    import jax

    from kimimaro_tpu.ops import fused_trace
    from kimimaro_tpu_torch.ops.chase import chase_batched

    d_pad, starts = _chase_lanes()
    path, plen, reached = chase_batched(torch.from_numpy(d_pad),
                                        torch.from_numpy(starts), 12)
    wp, wl, wr = jax.vmap(lambda dp, st: fused_trace._chase(dp, st, 12))(
        jnp.asarray(d_pad), jnp.asarray(starts, dtype=jnp.int32))
    np.testing.assert_array_equal(path.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(reached.numpy(), np.asarray(wr))
    assert bool(reached[4]) and int(path[4, 1, 0]) < 0

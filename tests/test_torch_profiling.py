"""The port's span tracer (kimimaro_tpu_torch.utils.profiling) on small
CPU runs of `skeletonize`: span ids, parents and call ids, the phases as
the spans' sums, the blocking reads counted against what the crop engine
is known to have read, collection off and without synchronizes, the
spans on the clock of torch.profiler's events, and the host stages' outer
phase with every read made inside it."""

import time

import numpy as np
import pytest
import torch

import kimimaro_tpu_torch
from kimimaro_tpu_torch import engine
from kimimaro_tpu_torch.ops import chase, geodesic
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

MS = 1_000_000
# small invalidation balls, so the tee takes a path a branch
KW = dict(teasar_params={"scale": 1.5, "const": 2}, anisotropy=(1, 1, 1),
          dust_threshold=10, device="cpu")


def _tee():
    """One label only, so the global engine hands it to the crop engine: a
    bar along x with a branch along y."""
    vol = np.zeros((40, 32, 16), np.uint32)
    vol[2:38, 8:12, 6:10] = 5
    vol[18:22, 8:30, 6:10] = 5
    return vol


def _run(vol=None, sync=True):
    profiling.reset_stats()
    profiling.collect(True, sync=sync)
    try:
        out = kimimaro_tpu_torch.skeletonize(
            _tee() if vol is None else vol, **KW)
    finally:
        profiling.collect(False)
    return out


@pytest.fixture(autouse=True)
def _collection_off():
    yield
    profiling.collect(False)
    profiling.reset_stats()


def test_spans_have_ids_parents_and_one_call_id_a_call():
    _run()
    first = profiling.spans()
    vol = _tee()
    vol[30:36, 20:30, 2:6] = 7        # a second call on another volume
    profiling.collect(True)
    try:
        kimimaro_tpu_torch.skeletonize(vol, **KW)
    finally:
        profiling.collect(False)
    spans = profiling.spans()
    assert spans[:len(first)] == first          # no reset: appended
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["skeletonize", "skeletonize"]
    assert roots[0]["call"] != roots[1]["call"]
    for s in spans:
        assert s["end_ns"] is not None and s["start_ns"] <= s["end_ns"]
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["call"] == p["call"]
    calls = {s["call"] for s in spans}
    assert calls == {roots[0]["call"], roots[1]["call"]}
    names = {s["name"] for s in spans}
    assert {"upload", "ccl", "edt", "crop_engine", "crop_lanes",
            "crop_fields", "crop_path", "crop_drain",
            "crop_engine_wait"} <= names
    kids = {(by_id[s["parent"]]["name"], s["name"]) for s in spans
            if s["parent"] is not None}
    assert {("crop_engine", "crop_lanes"), ("crop_lanes", "crop_fields"),
            ("crop_lanes", "crop_path"), ("crop_lanes", "crop_drain"),
            ("crop_path", "crop_engine_wait")} <= kids
    lanes = [s for s in spans if s["name"] == "crop_lanes"]
    assert lanes[0]["attrs"]["labels"] == [1]
    assert lanes[0]["attrs"]["lanes"] == 1
    assert lanes[0]["attrs"]["rung"] == engine.RELAX_ROUNDS
    assert all(s["attrs"]["lanes"] == 1 for s in spans
               if s["name"] == "crop_path" and s["attrs"])


def test_phases_are_the_spans_seconds_summed_by_name():
    _run()
    spans = profiling.spans()
    phases = profiling.get_stats()["phases"]
    want = {}
    for s in spans:
        want[s["name"]] = want.get(s["name"], 0) + s["end_ns"] - s["start_ns"]
    assert set(phases) == set(want)
    for name, ns in want.items():
        assert phases[name] == ns * 1e-9, name


def test_crop_engine_reads_are_counted_as_the_engine_makes_them(monkeypatch):
    # the crop engine's reads of one lane set that converges on its first
    # rung: one soma-refill selection, one change test a relaxation round,
    # one lane selection a ball relaxation (`_relax_where`), one a path
    # iteration and one to end the loop, the chase's checks and the
    # drain's three copies
    sweeps, wheres = [], []
    sweep, where = geodesic.sweep_axis0_batched, engine._relax_where

    def counted_sweep(*args, **kwargs):
        sweeps.append(1)
        return sweep(*args, **kwargs)

    def counted_where(*args, **kwargs):
        wheres.append(1)
        return where(*args, **kwargs)

    got = {}
    trace = engine.trace_batched

    def kept(*args, **kwargs):
        results, fallback = trace(*args, **kwargs)
        got.update(results)
        return results, fallback

    monkeypatch.setattr(geodesic, "sweep_axis0_batched", counted_sweep)
    monkeypatch.setattr(engine, "_relax_where", counted_where)
    monkeypatch.setattr(engine, "trace_batched", kept)
    skels = _run()
    counters = profiling.get_stats()["counters"]
    assert set(skels) == {5}
    assert counters["crop_engine_jobs"] == 1
    assert counters["fallback_jobs"] == 0 and counters["relax_retries"] == 0
    assert "gengine_iterations" not in counters
    (paths,) = got.values()
    iterations = len(paths)
    assert counters["crop_path_iterations"] == iterations >= 2
    rounds = len(sweeps) // 6           # six sweeps a round
    assert len(sweeps) == 6 * rounds
    # the chase checks every `_CHASE_CHECK` steps from step 0 until the
    # first check after its lane reached the rail (a path's vertices are
    # its steps)
    every = chase._CHASE_CHECK
    checks = sum(-(-len(p) // every) + 1 for p, _ in paths)
    want = 1 + rounds + len(wheres) + iterations + 1 + checks + 3
    assert counters["crop_engine_syncs"] == want
    syncs = sum(v for k, v in counters.items() if k.endswith("_syncs"))
    waits = [s for s in profiling.spans() if s["name"].endswith("_wait")]
    assert len(waits) == syncs
    assert len([s for s in waits if s["name"] == "crop_engine_wait"]) == want


def test_collection_off_records_nothing_and_sync_false_never_syncs(
        monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "_sync", lambda device: calls.append(1))
    profiling.reset_stats()
    kimimaro_tpu_torch.skeletonize(_tee(), **KW)
    assert profiling.spans() == []
    assert profiling.get_stats() == {"phases": {}, "counters": {}}
    assert calls == []
    _run(sync=False)
    assert calls == []
    assert profiling.get_stats()["counters"]["crop_engine_syncs"] > 0
    _run()
    # two a phase: upload, ccl, edt, label_info, border_targets, gengine,
    # crop_engine, finalize, host_fallback, merge (the device test is
    # _sync's own)
    assert len(calls) == 20


def test_span_host_and_phase_outside_a_call():
    assert profiling.host(torch.tensor([1, 2])).tolist() == [1, 2]
    with profiling.span("off") as s:
        assert s is None
    profiling.reset_stats()
    profiling.collect(True)
    with profiling.phase("outer"):
        with profiling.phase("inner"):
            with profiling.span("step", k=1):
                profiling.annotate(lanes=3)
                assert profiling.host(torch.tensor(True), bool) is True
    assert profiling.host(torch.tensor([0, 1]), torch.nonzero).tolist() \
        == [[1]]
    profiling.collect(False)
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["outer", "inner", "step",
                                          "outer_wait", "wait"]
    assert [s["parent"] for s in spans] == [
        None, spans[0]["id"], spans[1]["id"], spans[2]["id"], None]
    assert spans[2]["attrs"] == {"k": 1, "lanes": 3}
    assert {s["call"] for s in spans} == {None}
    assert profiling.get_stats()["counters"] == {"outer_syncs": 1,
                                                 "syncs": 1}


def test_spans_share_the_clock_of_torch_profiler_events():
    from torch.profiler import ProfilerActivity, profile

    profiling.reset_stats()
    profiling.collect(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            kimimaro_tpu_torch.skeletonize(_tee(), **KW)
    finally:
        profiling.collect(False)
    spans = profiling.spans()
    (crop,) = [s for s in spans if s["name"] == "crop_engine"]
    loops = [s for s in spans if s["name"] == "crop_path"]
    nonzero = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name() == "aten::nonzero"]
    inside = [(a, b) for a, b in nonzero
              if crop["start_ns"] - MS <= a and b <= crop["end_ns"] + MS]
    assert len(inside) >= len(loops) >= 2
    for s in loops:
        # each path iteration selects its lanes first
        assert any(s["start_ns"] - MS <= a and b <= s["end_ns"] + MS
                   for a, b in inside), s


def test_host_stages_span_encloses_its_phases_and_counts_every_read(
        monkeypatch):
    # fill_holes and fix_avocados at 64^3: one outer phase from the
    # labels' download to the host's counts and boxes, and each blocking
    # read made inside it counted under it
    from chip_smoke import small_fill_volume

    vol = small_fill_volume()
    kw = dict(teasar_params={"scale": 1.5, "const": 300,
                             "soma_detection_threshold": 1100,
                             "soma_acceptance_threshold": 3500},
              anisotropy=(16, 16, 40), dust_threshold=1000,
              fill_holes=True, fix_avocados=True, device="cpu")
    want = kimimaro_tpu_torch.skeletonize(vol, **kw)
    reads = []
    host = profiling.host

    def timed(t, read=None):
        reads.append(time.time_ns())
        return host(t, read)

    monkeypatch.setattr(profiling, "host", timed)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.skeletonize(vol, **kw)
    finally:
        profiling.collect(False)
    spans = profiling.spans()
    by_id = {s["id"]: s for s in spans}
    (outer,) = [s for s in spans if s["name"] == "host_stages"]

    def inside(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
            if s is outer:
                return True
        return False

    names = ("fill_holes", "avocado_pass", "avocado_edt", "host_label_info")
    for name in names:
        held = [s for s in spans if s["name"] == name]
        assert held and all(inside(s) for s in held), name
    counters = profiling.get_stats()["counters"]
    routed = sum(outer["start_ns"] <= t <= outer["end_ns"] for t in reads)
    assert counters["host_stages_syncs"] == routed > 0
    assert not any(k in counters for k in (
        "fill_holes_syncs", "avocado_pass_syncs", "avocado_edt_syncs"))
    passes = [s for s in spans if s["name"] == "avocado_pass"]
    assert len(passes) == counters["avocado_passes"]
    assert sum(s["attrs"]["candidates"] for s in passes) \
        == counters["avocado_candidates"] > 0
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].vertices, want[k].vertices)
        np.testing.assert_array_equal(got[k].edges, want[k].edges)
        np.testing.assert_array_equal(got[k].radii, want[k].radii)

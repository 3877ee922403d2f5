"""The trace arithmetic and the kernels' byte counts, on synthetic events
and small CPU calls."""

import pytest
import torch

import devtrace
import spy
from layers import b2_roofline, b4_roofline, idle_share
from peaks import HBM_BYTES_PER_S


def test_union_counts_overlapping_streams_once():
    ev = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert devtrace.union_seconds(ev) == pytest.approx(26e-6)
    assert devtrace.union_seconds([]) == 0.0


def test_gaps_and_idle_by_phase():
    dev = [("k", 10, 20), ("k", 15, 30), ("k", 50, 60)]
    assert devtrace.gaps([(s, e) for _, s, e in dev], 0, 100) == \
        [(0, 10), (30, 50), (60, 100)]
    host = [("chunk", 0, 100), ("edt", 25, 55), ("crop_engine", 55, 100)]
    idle = devtrace.idle_by_phase(dev, host, 0, 100)
    assert idle == pytest.approx({"chunk": 10e-6, "edt": 20e-6,
                                  "crop_engine": 40e-6})


def test_time_by_name():
    dev = [("void dual_plane<1>", 0, 4), ("grid_strips<DualOp<0>>", 4, 10),
           ("void dual_plane<1>", 12, 13)]
    by = devtrace.time_by_name(dev)
    assert by == pytest.approx({"void dual_plane<1>": 5e-6,
                                "grid_strips<DualOp<0>>": 6e-6})


def test_kernel_spy_counts_each_operand_once():
    from kimimaro_tpu_torch.ops import geodesic, gsweep

    n = (4, 5, 6)
    vox = 4 * 5 * 6
    f = torch.zeros(n)
    cc = torch.ones(n, dtype=torch.int32)
    ok = torch.ones(n, dtype=torch.bool)
    ks = spy.KernelSpy()
    try:
        gsweep.sweep0_dual(f, f, cc, f, ok, (1.0, 1.0, 1.0), "ball_rail",
                           False)
        gsweep.sweep0_dual(f, f, cc, None, None, (1.0, 1.0, 1.0), "max2",
                           False)
        b = (2,) + n
        d, okb = torch.zeros(b), torch.ones(b, dtype=torch.bool)
        gate = torch.zeros(b, dtype=torch.int32)
        geodesic.sweep_axis0_batched(d, okb, None, (1.0, 1.0, 1.0), False,
                                     False)
        geodesic.sweep_axis0_batched(d, okb, d, (1.0, 1.0, 1.0), True,
                                     False)
        geodesic.sweep_axis0_batched(
            d, okb, d, (1.0, 1.0, 1.0), True, False, gate=gate,
            gate_bits9=tuple(range(9)))
    finally:
        ks.close()
    assert ks.calls["b2"] == [25 * vox, 20 * vox]
    assert ks.calls["b4"] == [9 * 2 * vox, 13 * 2 * vox, 17 * 2 * vox]
    assert gsweep.sweep0_dual is ks._b2


def test_rooflines_and_idle_share_from_a_record():
    prof = {"window_s": 2.0, "busy_s": 0.5,
            "device_s": {"grid_strips<DualOp<0>>": 1e-3,
                         "batched_cluster<BatchedOp<true>>": 2e-3,
                         "other": 1.0},
            "calls": {"b2": [HBM_BYTES_PER_S * 5e-4],
                      "b4": [HBM_BYTES_PER_S * 1e-4] * 2},
            "launches": {}}
    rec = {"chunks": 1, "phases": {}, "counters": {}, "profile": prof}
    assert b2_roofline.read(rec) == pytest.approx(50.0)
    assert b4_roofline.read(rec) == pytest.approx(10.0)
    assert idle_share.read(rec) == pytest.approx(75.0)
    prof["launches"] = {"sweep_axis0": 3}
    assert b4_roofline.read(rec) is None
    assert b2_roofline.read({**rec, "profile": {**prof, "calls": {}}}) \
        is None

"""The per-layer metrics that read the program's spans and counters: each
one's value from a hand-built record of two chunks, and None where the
record lacks what it reads (a program without the span or counter)."""

import importlib

import pytest

PHASES = {"upload_wait": 0.5, "ccl_wait": 1.0, "edt_wait": 0.25,
          "border_targets_wait": 0.25, "gengine_wait": 3.0,
          "crop_engine_wait": 5.0, "crop_fields": 2.0, "crop_path": 6.0,
          "crop_drain": 1.0, "crop_engine": 10.0}
COUNTERS = {"ccl_syncs": 20, "edt_syncs": 4, "label_info_syncs": 10,
            "border_targets_syncs": 6, "gengine_syncs": 300,
            "crop_engine_syncs": 5000, "crop_path_iterations": 700}

# metric: (value a chunk, the phase or counter names whose absence
# leaves it with nothing to read)
EXPECTED = {
    "preamble_syncs": (20.0, ("ccl_syncs", "edt_syncs", "label_info_syncs",
                              "border_targets_syncs")),
    "preamble_wait_s": (1.0, ("upload_wait", "ccl_wait", "edt_wait",
                              "border_targets_wait")),
    "gengine_syncs": (150.0, ("gengine_syncs",)),
    "gengine_wait_s": (1.5, ("gengine_wait",)),
    "crop_syncs": (2500.0, ("crop_engine_syncs",)),
    "crop_wait_s": (2.5, ("crop_engine_wait",)),
    "crop_fields_s": (1.0, ("crop_fields",)),
    "crop_loop_s": (3.0, ("crop_path",)),
    "crop_drain_s": (0.5, ("crop_drain",)),
    "crop_path_iters": (350.0, ("crop_path_iterations",)),
}


def _record(phases=PHASES, counters=COUNTERS, chunks=2):
    return {"chunks": chunks, "phases": dict(phases),
            "counters": dict(counters), "launches": {}, "profile": None}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_span_or_counter_metric_reads_its_record(metric):
    read = importlib.import_module(f"layers.{metric}").read
    want, names = EXPECTED[metric]
    assert read(_record()) == pytest.approx(want)
    # the parent's record: the program has no such span or counter
    left = _record({k: v for k, v in PHASES.items() if k not in names},
                   {k: v for k, v in COUNTERS.items() if k not in names})
    assert read(left) is None
    assert read(_record(chunks=0)) is None

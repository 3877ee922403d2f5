"""Blocking device reads a chunk makes in the preamble (counters
`<phase>_syncs` of the phases `upload`, `ccl`, `edt`, `label_info` and
`border_targets`, `kimimaro_tpu_torch.utils.profiling.host`); none where
the program counts no such read."""

from layers._per_chunk import counter

PHASES = ("upload", "ccl", "edt", "label_info", "border_targets")


def read(rec):
    got = [counter(rec, p + "_syncs") for p in PHASES]
    got = [g for g in got if g is not None]
    return sum(got) if got else None

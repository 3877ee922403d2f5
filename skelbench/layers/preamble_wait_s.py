"""Seconds a chunk's preamble waits in blocking device reads (spans
`<phase>_wait` of the phases `upload`, `ccl`, `edt`, `label_info` and
`border_targets`)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("upload_wait", "ccl_wait", "edt_wait",
                        "label_info_wait", "border_targets_wait"))

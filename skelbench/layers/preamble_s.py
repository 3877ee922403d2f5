"""Seconds a chunk spends in the preamble: upload, CCL, EDT, label_info and
the border targets (`kimimaro_tpu_torch.intake`)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("upload", "ccl", "edt", "label_info",
                        "border_targets"))

"""Seconds a chunk's crop engine spends from the lanes' crops to their
first rails (span `crop_fields`: soma refill, root, DAF, PDRF)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("crop_fields",))

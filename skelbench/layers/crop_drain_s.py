"""Seconds a chunk's crop engine spends copying its lane sets' paths to
the host and unpacking them (spans `crop_drain`)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("crop_drain",))

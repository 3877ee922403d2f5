"""Seconds a chunk's crop engine spends in its path loops (spans
`crop_path`, one a path iteration of a lane set)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("crop_path",))

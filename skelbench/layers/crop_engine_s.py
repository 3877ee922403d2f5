"""Seconds a chunk spends in the crop engine (phase `crop_engine`)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("crop_engine",))

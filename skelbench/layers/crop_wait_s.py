"""Seconds a chunk's crop engine waits in blocking device reads (span
`crop_engine_wait`); the rest of `crop_engine_s` the host spends
launching."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("crop_engine_wait",))

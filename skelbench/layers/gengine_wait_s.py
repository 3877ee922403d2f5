"""Seconds a chunk's global engine waits in blocking device reads (span
`gengine_wait`)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("gengine_wait",))

"""Seconds a chunk's host stages wait in blocking device reads (span
`host_stages_wait`); the rest of `host_stages_s` is host work and
launching."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("host_stages_wait",))

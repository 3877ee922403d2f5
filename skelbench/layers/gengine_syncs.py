"""Blocking device reads a chunk makes in the global engine (counter
`gengine_syncs`)."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "gengine_syncs")

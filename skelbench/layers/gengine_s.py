"""Seconds a chunk spends in the global engine (`gengine_setup` and
`gengine_loop`); none where the global engine did not run."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("gengine_setup", "gengine_loop"))

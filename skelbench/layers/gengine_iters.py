"""Lock-step iterations of the global engine a chunk."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "gengine_iterations")

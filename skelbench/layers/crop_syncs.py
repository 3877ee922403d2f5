"""Blocking device reads a chunk makes in the crop engine (counter
`crop_engine_syncs`): the relaxation rounds' change tests, the lane
selections, the chase's checks and the drains."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "crop_engine_syncs")

"""Seconds a chunk spends filling holes (phase `fill_holes`: the batched
hole masks on the device and their serial application on the host)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("fill_holes",))

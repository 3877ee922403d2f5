"""Seconds a chunk spends in the host stages of `fill_holes` and
`fix_avocados` (span `host_stages`: the labels' download, hole filling,
avocado passes and their EDTs, the host's counts and boxes); none where
the chunk ran no host stage."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("host_stages",))

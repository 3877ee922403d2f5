"""Blocking device reads a chunk makes in the host stages (counter
`host_stages_syncs`, `kimimaro_tpu_torch.utils.profiling.host`): the
labels' download, the hole masks' floods and copies, the avocado
passes' fills, each EDT's download and the renumbering's reads."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "host_stages_syncs")

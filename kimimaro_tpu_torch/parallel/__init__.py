"""The multi-device path (kimimaro_tpu.parallel): one process drives a
list of devices (`make_mesh`), a volume is held as leading-axis slabs, one
per device (`shard_volume`), and the preamble, the global engine and the
crop engines run over the slabs with explicit exchanges between them
(`parallel.comm`)."""

from .sharded import (
    AXIS,
    make_mesh,
    preamble_step,
    shard_volume,
    sharded_ccl_rounds,
    sharded_distance_rounds,
    sharded_edtsq,
)
from .skeletonize import skeletonize_sharded

__all__ = [
    "AXIS",
    "make_mesh",
    "preamble_step",
    "shard_volume",
    "sharded_ccl_rounds",
    "sharded_distance_rounds",
    "sharded_edtsq",
    "skeletonize_sharded",
]

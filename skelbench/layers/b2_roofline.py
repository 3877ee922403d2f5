"""B2 (`csrc/gsweep.cu`, the global engine's dual sweep: kernels
`dual_plane` and the strips of `DualOp`) against its roofline."""

from layers._roofline import share


def read(rec):
    return share(rec, "b2", ("dual_plane", "DualOp"))

"""B4 (`csrc/sweep.cu`, the crop engine's batched sweep, gated and
ungated: kernels `batched_plane` and the strips of `BatchedOp`) against
its roofline. B5's one-lane per-plane form is `batched_plane` too, so a
chunk that launched B5 gives no reading."""

from layers._roofline import share


def read(rec):
    return share(rec, "b4", ("batched_plane", "BatchedOp"),
                 exclusive_launches=("sweep_axis0", "sweep_axis0_vg"))

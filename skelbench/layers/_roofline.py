"""A kernel's share of its roofline in the profiled chunk: the bytes its
calls need (each operand read once, each output written once, from the
shapes: `spy.KernelSpy`) over the HBM rate, against its device time. The
operations of B2 and B4 (at most 40 and 18 a voxel) take less time at the
float32 peak than their bytes at the HBM rate, so bytes bound both."""

from peaks import HBM_BYTES_PER_S


def share(rec, key, marks, exclusive_launches=()):
    prof = rec.get("profile")
    if not prof or not prof["calls"].get(key):
        return None
    if any(prof["launches"].get(k, 0) for k in exclusive_launches):
        return None     # another wrapper's launches share these kernels
    secs = sum(s for name, s in prof["device_s"].items()
               if any(m in name for m in marks))
    if secs <= 0:
        return None
    return 100.0 * sum(prof["calls"][key]) / HBM_BYTES_PER_S / secs

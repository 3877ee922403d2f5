"""The rail-field pointer chase and the default relax depth.

Counterpart of kimimaro_tpu.ops.fused_trace (`RELAX_ROUNDS`, `_chase`)
without the fused on-device path loop: the host trace path (trace.py) and
the global engine (gengine.py) use the host `_chase`; the crop engine
(engine.py) walks all lanes of a batch at once on the device with
`chase_batched`.

For CUDA tensors `chase_batched` launches C1 (csrc/chase.cu), one launch
a chase; for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..utils import profiling
from .stencils import GRAPH_BITS

# Default sweep-round count of a relaxation stage. Rounds needed = number
# of "bends" in the worst geodesic; compact shapes converge in a handful,
# and callers escalate (or flag) what is still changing after it.
RELAX_ROUNDS = 6

INF = np.float32(np.inf)


def _chase_bit_table() -> np.ndarray:
    """The voxel-graph bit that opens a chase step cur -> cur + o, for
    each of the 27 window positions: the relaxation edge ran cur + o ->
    cur, so the neighbour's bit for -o must be set (31, never set, at the
    centre)."""
    bits = np.full((27,), 31, dtype=np.int64)
    for k in range(27):
        o = (k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1)
        if o != (0, 0, 0):
            bits[k] = GRAPH_BITS[(-o[0], -o[1], -o[2])]
    return bits


CHASE_BITS = _chase_bit_table()
# the same table as the C int[27] that C1 takes by value
_CHASE_BITS_C = (ctypes.c_int * 27)(*CHASE_BITS.tolist())


def _chase(d_pad, start, max_len: int, vg_pad=None):
    """Walk the shortest-path tree from `start` to the nearest rail
    (d <= 0): at each voxel step to the 26-neighbour minimizing the rail
    distance (first-minimum tie break in lexicographic offset order).

    d_pad: the rail field (numpy) padded by one +inf voxel on every side;
    the walk runs on the host. vg_pad (optional): the voxel graph (a
    numpy integer array) padded by one zero voxel: a step is open only where
    the neighbour's bit for the move back is set. Returns (path (L, 3)
    int32 with -1 padding, length, reached_rail). The centre read and the
    3x3x3 windows follow JAX's index rule for scalar reads and dynamic
    slices: a negative index counts from the end once, then clamps to the
    volume."""
    L = int(max_len)
    size = np.asarray(d_pad.shape, dtype=np.int64)
    path = np.full((L, 3), -1, dtype=np.int32)
    cur = np.asarray(start, dtype=np.int64).reshape(3)
    i = 0
    reached = False
    while i < L:
        path[i] = cur
        i += 1
        c = _wrap_clamp_host(cur + 1, size, size - 1)
        if d_pad[c[0], c[1], c[2]] <= 0.0:
            reached = True
            break
        o = _wrap_clamp_host(cur, size, size - 3)
        win = d_pad[o[0]:o[0] + 3, o[1]:o[1] + 3, o[2]:o[2] + 3]
        win = win.reshape(27).copy()
        win[13] = INF
        if vg_pad is not None:
            g = vg_pad[o[0]:o[0] + 3, o[1]:o[1] + 3, o[2]:o[2] + 3]
            g = g.reshape(27).astype(np.int64)
            win = np.where((g >> CHASE_BITS) & 1 > 0, win, INF)
        k = int(np.argmin(win))
        cur = cur + np.array([k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1])
    return path, i, reached


def _wrap_clamp_host(idx, size, hi):
    """`_wrap_clamp` on numpy index vectors."""
    idx = np.where(idx < 0, idx + size, idx)
    return np.minimum(np.maximum(idx, 0), hi)


# the 27 window offsets in lexicographic order (index 13 is the centre)
_WINDOW27 = np.array([(k // 9 - 1, (k // 3) % 3 - 1, k % 3 - 1)
                      for k in range(27)], dtype=np.int64)
_CHASE_CHECK = 8  # steps between all-lanes-done checks


def _wrap_clamp(idx, size, hi):
    """JAX's index rule for a dynamic slice or scalar read: a negative
    index counts from the end (once), then clamps to [0, hi]."""
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.minimum(torch.clamp(idx, min=0), hi)


def _chase_batched_plain(d_pad, start, max_len: int, vg_pad=None):
    """Plain torch version of C1: one step of every lane at a time, until
    no lane steps (checked every `_CHASE_CHECK` steps)."""
    B = d_pad.shape[0]
    L = int(max_len)
    dev = d_pad.device
    size = torch.tensor(d_pad.shape[1:], dtype=torch.int64, device=dev)
    strides = torch.tensor([d_pad.shape[2] * d_pad.shape[3], d_pad.shape[3],
                            1], dtype=torch.int64, device=dev)
    flat = d_pad.reshape(B, -1)
    vg_flat = None
    if vg_pad is not None:
        vg_flat = (vg_pad.view(torch.int32) if vg_pad.dtype == torch.uint32
                   else vg_pad).reshape(B, -1)
        chase_bits = torch.as_tensor(CHASE_BITS, dtype=torch.int32,
                                     device=dev)
    win27 = torch.as_tensor(_WINDOW27, device=dev)
    win_lin = ((win27 + 1) * strides).sum(dim=1)
    lanes = torch.arange(B, device=dev)

    path = torch.full((B, L, 3), -1, dtype=torch.int64, device=dev)
    cur = start.to(device=dev, dtype=torch.int64)
    i = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(L):
        go = ~done & (i < L)
        if (step % _CHASE_CHECK == 0
                and not profiling.host(go.any(), bool)):
            break
        slot = torch.clamp(i, max=L - 1)
        path[lanes, slot] = torch.where(go[:, None], cur, path[lanes, slot])
        c = _wrap_clamp(cur + 1, size, size - 1)
        at_rail = flat.gather(1, (c * strides).sum(1, keepdim=True))[:, 0]
        at_rail = at_rail <= 0.0
        o = _wrap_clamp(cur, size, size - 3)
        win_idx = (o * strides).sum(1, keepdim=True) + win_lin[None, :]
        win = flat.gather(1, win_idx)
        win[:, 13] = float("inf")
        if vg_flat is not None:
            g = vg_flat.gather(1, win_idx)
            win = torch.where(((g >> chase_bits) & 1) > 0, win,
                              float("inf"))
        nxt = cur + win27[torch.argmin(win, dim=1)]
        cur = torch.where((go & ~at_rail)[:, None], nxt, cur)
        i = torch.where(go, i + 1, i)
        done = done | (go & at_rail)
    return path, i, done


def chase_batched(d_pad, start, max_len: int, vg_pad=None):
    """`_chase` for every lane of a batch on the device, as the JAX crop
    engine's vmapped `fused_trace._chase` runs it: a lane steps while it
    has not reached a rail and has fewer than `max_len` vertices.

    d_pad: (B, X+2, Y+2, Z+2) float32 rail fields padded by one +inf voxel;
    start: (B, 3) int64 crop coordinates; vg_pad (optional): the lanes'
    voxel graphs (int32 or uint32) padded by one zero voxel, closing the
    steps whose move back the neighbour does not permit. Returns (path
    (B, L, 3) int64 with -1 padding, length (B,), reached_rail (B,)). The
    first minimum of the 26-window in lexicographic offset order wins;
    windows and reads follow JAX's dynamic-slice index rule at the padded
    edge."""
    if d_pad.device.type == "cpu":
        return _chase_batched_plain(d_pad, start, max_len, vg_pad)
    B, X, Y, Z = d_pad.shape
    L = int(max_len)
    if L < 0 or min(X, Y, Z) < 3:
        raise ValueError("chase_batched: max_len >= 0 and padded fields of "
                         "at least 3 voxels a side")
    name = "chase_batched"
    vg = None
    if vg_pad is not None:
        name = "chase_batched_vg"
        vg = vg_pad.view(torch.int32) if vg_pad.dtype == torch.uint32 \
            else vg_pad
    kernels.require_cuda(name, d_pad, vg,
                         dtypes=((torch.float32,), (torch.int32,)),
                         shape=d_pad.shape)
    dev = d_pad.device
    start = start.to(device=dev, dtype=torch.int64).contiguous()
    kernels.require_cuda(name, start, shape=(B, 3))
    path = torch.empty((B, L, 3), dtype=torch.int64, device=dev)
    length = torch.empty((B,), dtype=torch.int64, device=dev)
    reached = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return path, length, reached
    _launch(d_pad, vg, start, L, path, length, reached)
    kernels.LAUNCHES[name] += 1
    return path, length, reached


def _launch(d_pad, vg, start, L: int, path, length, reached) -> None:
    """One launch of C1 into the given outputs, on the current stream, with
    no checks: `chase_batched`'s arguments as it has checked them (`vg`
    int32 or None, `start` int64, all contiguous on one CUDA device)."""
    B, X, Y, Z = d_pad.shape
    rc = kernels.lib().kt_chase_batched(
        kernels.ptr(d_pad), kernels.ptr(vg), kernels.ptr(start), B, X, Y, Z,
        L, _CHASE_BITS_C, kernels.ptr(path), kernels.ptr(length),
        kernels.ptr(reached), kernels.stream_ptr(d_pad.device))
    kernels.check(rc, "chase_batched")

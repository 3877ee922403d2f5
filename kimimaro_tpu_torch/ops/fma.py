"""Fused multiply-add in float32, as XLA:CPU computes `a*b + c`.

XLA:CPU contracts an elementwise `a*b + c` of float32 arrays into one
fused multiply-add: the product and the sum are rounded once, not twice.
The JAX package's PDRF, invalidation radii and cross-section planes are
computed that way, so the port computes those lines
with `fma_f32` to stay bit-equal.

For CUDA tensors `fma_f32` launches kernel F1 (csrc/fma.cu, one pass of
__fmaf_rn). Its plain version, for CPU tensors: the product of two
float32 values is exact in float64; the sum with `c` is taken in float64
and made round-to-odd: where the float64 sum was inexact (TwoSum's error
term is nonzero) and its last mantissa bit is even, it steps one ulp
toward the error. A round-to-odd result with at least two more bits than
float32 rounds to the correctly rounded float32 of `a*b + c` (no double
rounding). Both give that correctly rounded value.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

# elements per float64 chunk: a 512^3 field would otherwise take several
# float64 temporaries of 1 GiB each
CHUNK = 1 << 24


def _fma_chunk(a, b, c):
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    # TwoSum: s + err == p + c exactly
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    step = even & (err != 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(step, torch.nextafter(s, toward), s)
    return s.float()


def _fma_f32_plain(a, b, c) -> torch.Tensor:
    """Plain torch version of kernel F1: float64, round-to-odd, in chunks
    of CHUNK elements."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    shape = a.shape
    n = a.numel()
    if a.dim() == 0 or n <= CHUNK:
        return _fma_chunk(a.contiguous(), b.contiguous(), c.contiguous())
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    per = max(1, n // shape[0])
    step = max(1, CHUNK // per)
    for i in range(0, shape[0], step):
        sl = slice(i, i + step)
        out[sl] = _fma_chunk(a[sl], b[sl], c[sl])
    return out


def _collapse(shape, strides):
    """Merge adjacent dimensions that every operand walks contiguously
    (and drop size-1 ones): (sizes, [strides of each operand])."""
    dims = [(n, [s[k] for s in strides]) for k, n in enumerate(shape)
            if n != 1]
    out = []
    for n, st in dims:
        if out and all(ps == cs * n for ps, cs in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * n, st)
        else:
            out.append((n, st))
    return [n for n, _ in out], [[st[k] for _, st in out]
                                 for k in range(len(strides))]


def fma_f32(a, b, c) -> torch.Tensor:
    """The correctly rounded float32 of a*b + c, elementwise with
    broadcasting. Each operand is a float32 tensor or a Python float
    (taken as float32); the tensors lie on one device."""
    ts = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    if not ts:
        raise TypeError("fma_f32: needs a tensor operand")
    dev = ts[0].device
    for x in ts:
        if x.dtype != torch.float32:
            raise TypeError(f"fma_f32 takes float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"fma_f32: operands on {dev} and {x.device}")
    if dev.type == "cpu":
        return _fma_f32_plain(*(
            x if isinstance(x, torch.Tensor)
            else torch.tensor(x, dtype=torch.float32) for x in (a, b, c)))
    shape = torch.broadcast_shapes(*(x.shape for x in ts))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    views = [x.broadcast_to(shape) if isinstance(x, torch.Tensor) else None
             for x in (a, b, c)]
    sizes, strides = _collapse(
        tuple(shape), [v.stride() if v is not None else (0,) * len(shape)
                       for v in views])
    if len(sizes) > 4:
        raise ValueError(f"fma_f32: operands of shape {tuple(shape)} do "
                         f"not fold into 4 dimensions")
    pad = 4 - len(sizes)
    sizes = [1] * pad + sizes
    args = []
    for x, v, st in zip((a, b, c), views, strides):
        arr = (ctypes.c_longlong * 4)(*([0] * pad + st))
        if v is None:
            args += [None, float(np.float32(x)), arr]
        else:
            args += [v.data_ptr(), 0.0, arr]
    rc = kernels.lib().kt_fma_f32(*args, kernels.ptr(out), *sizes,
                                  kernels.stream_ptr(dev))
    kernels.check(rc, "fma_f32")
    kernels.LAUNCHES["fma_f32"] += 1
    return out

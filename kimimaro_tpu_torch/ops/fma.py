"""Fused multiply-add in float32, as XLA:CPU computes `a*b + c`.

XLA:CPU contracts an elementwise `a*b + c` of float32 arrays into one
fused multiply-add: the product and the sum are rounded once, not twice.
The JAX package's PDRF, invalidation radii and cross-section planes are
computed that way, so the port computes those lines
with `fma_f32` to stay bit-equal.

`negate=True` gives the correctly rounded c - a*b (the same value as
fma(-a, b, c), without a negated copy of a).

For CUDA tensors `fma_f32` launches kernel F1 (csrc/fma.cu, one pass of
__fmaf_rn, by the route `fma_plan` picks). Its plain version, for CPU
tensors: the product of two float32 values is exact in float64; the sum
with `c` is taken in float64 and made round-to-odd: where the float64
sum was inexact (TwoSum's error term is nonzero) and its last mantissa
bit is even, it steps one ulp toward the error. A round-to-odd result
with at least two more bits than float32 rounds to the correctly rounded
float32 of `a*b + c` (no double rounding). Both give that correctly
rounded value.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

# elements per float64 chunk: a 512^3 field would otherwise take several
# float64 temporaries of 1 GiB each
CHUNK = 1 << 24


def _fma_chunk(a, b, c, negate=False):
    a = a.double()
    p = (-a if negate else a) * b.double()
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


def _fma_f32_plain(a, b, c, negate=False) -> torch.Tensor:
    """Plain torch version of kernel F1: float64, round-to-odd, in chunks
    of CHUNK elements; `negate` takes fma(-a, b, c) = c - a*b (the sign
    flip is exact)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    shape = a.shape
    n = a.numel()
    if a.dim() == 0 or n <= CHUNK:
        return _fma_chunk(a.contiguous(), b.contiguous(), c.contiguous(),
                          negate)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    per = max(1, n // shape[0])
    step = max(1, CHUNK // per)
    for i in range(0, shape[0], step):
        sl = slice(i, i + step)
        out[sl] = _fma_chunk(a[sl], b[sl], c[sl], negate)
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


# how the flat route reads an operand (csrc/fma.cu FlatMode)
CONST, SCALAR, VECTOR, UNALIGNED = 0, 1, 2, 3
_INT31 = 1 << 31


def magic_divisor(d: int):
    """(d, magic, shift) with n // d == ((n * magic >> 32) + n) >> shift
    for every 0 <= n < 2^31: the kernel's division-free split of an
    index (csrc/fma.cu `divide`)."""
    if not 1 <= d < _INT31:
        raise ValueError(f"magic_divisor: {d} is out of range")
    shift = (d - 1).bit_length()
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    assert magic < 1 << 32
    return d, magic, shift


def _broadcast_shape(shapes):
    """torch.broadcast_shapes of plain shapes, without its tracing
    machinery (a tenth of the host time of a small call)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for k, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[k] not in (1, n):
                    raise ValueError(f"fma_f32: shapes {shapes} do not "
                                     f"broadcast")
                out[k] = n
    return tuple(out)


def fma_plan(shape, operands):
    """The route F1 takes for an output of `shape` and the operands
    (each a tensor that broadcasts to `shape`, or a Python float):
    {"route": "flat", "n", "modes"} where every tensor operand walks the
    output with stride 1 (read as 16-byte vectors where its base is
    16-byte aligned, UNALIGNED otherwise) or is one element, else
    {"route": "strided", "total", "sizes", "strides", "divs"} over at
    most four collapsed dimensions with 32-bit strides. Raises where
    neither route takes the operands."""
    shape = tuple(int(n) for n in shape)
    total = 1
    for n in shape:
        total *= n
    ts = [x if isinstance(x, torch.Tensor) else None for x in operands]
    views = [None if x is None else x.broadcast_to(shape) for x in ts]
    sizes, strides = _collapse(shape, [
        v.stride() if v is not None else (0,) * len(shape) for v in views])
    if len(sizes) <= 1 and all(st[0] in (0, 1) for st, v in
                               zip(strides, views)
                               if v is not None and sizes):
        modes = []
        for v, st in zip(views, strides):
            if v is None:
                modes.append(CONST)
            elif not sizes or st[0] == 0:
                modes.append(SCALAR)
            else:
                modes.append(VECTOR if v.data_ptr() % 16 == 0
                             else UNALIGNED)
        return {"route": "flat", "n": total, "modes": tuple(modes)}
    if len(sizes) > 4:
        raise ValueError(f"fma_f32: operands of shape {shape} do not fold "
                         f"into 4 dimensions")
    if total >= _INT31 or any(
            sum((n - 1) * s for n, s in zip(sizes, st)) >= _INT31
            for st in strides):
        raise ValueError(f"fma_f32: a broadcast of shape {shape} needs "
                         f"64-bit offsets")
    pad = 4 - len(sizes)
    return {"route": "strided", "total": total, "sizes": [1] * pad + sizes,
            "strides": [[0] * pad + st for st in strides],
            "divs": [magic_divisor(n) for n in ([1] * pad + sizes)[1:]]}


def fma_f32(a, b, c, negate: bool = False) -> torch.Tensor:
    """The correctly rounded float32 of a*b + c (of c - a*b with
    `negate`), elementwise with broadcasting. Each operand is a float32
    tensor or a Python float (taken as float32); the tensors lie on one
    device."""
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
            else torch.tensor(x, dtype=torch.float32) for x in (a, b, c)),
            negate=negate)
    shape = _broadcast_shape([x.shape for x in ts])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    ops = (a, b, c)
    plan = fma_plan(shape, ops)
    lib = kernels.lib()
    stream = kernels.stream_ptr(dev)
    consts = [0.0 if isinstance(x, torch.Tensor) else float(np.float32(x))
              for x in ops]
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else None
            for x in ops]
    if plan["route"] == "flat":
        args = [v for p, k, m in zip(ptrs, consts, plan["modes"])
                for v in (p, k, m)]
        rc = lib.kt_fma_f32_flat(*args, int(negate), kernels.ptr(out),
                                 plan["n"], stream)
    else:
        args = [v for p, k, st in zip(ptrs, consts, plan["strides"])
                for v in (p, k, (ctypes.c_int * 4)(*st))]
        divs = (ctypes.c_uint * 9)(*[x for d in plan["divs"] for x in d])
        rc = lib.kt_fma_f32_strided(*args, int(negate), kernels.ptr(out),
                                    plan["total"], divs, stream)
    kernels.check(rc, "fma_f32")
    kernels.LAUNCHES["fma_f32"] += 1
    return out

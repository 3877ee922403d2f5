"""Bit-plane section floods of windowed cross sections (kernel X1).

Torch counterpart of the flood machinery of kimimaro_tpu.ops.xsslab and
kimimaro_tpu.ops.xsbatch. A sectioning plane whose dominant axis is z
(after a permutation) is a height field over a (Wx, Wy) window of
columns; each column's K = 5 cells around the plane are the low bits of
one int32 word, bit k at z = zb + k. The 26-connected flood of the
section is an elementwise stencil over the words: a neighbour column's
bits re-base into this column's frame by a variable shift of the zb
delta, a +-1 shift adds the true-z dilation, and an AND with the section
word clips to the section.

`section_flood` runs one of two floods over a batch of lanes:
  - "dilate": per round, the 8-neighbour dilation of every word;
  - "sweep": per round, four directed full-window sweeps (+x, -x, +y,
    -y) whose carry is the previous row.
The JAX loops run `rounds + 1` rounds and report whether the last one
changed a word. A round is a function of the words alone, so once a
lane's round changes nothing, every later round would too: both versions
here stop a lane there, which returns the same (kept, changed). For CUDA
tensors the wrapper launches kernel X1 (csrc/xsflood.cu); for CPU
tensors it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

K = 5
_METHODS = ("dilate", "sweep")
# the packed forms of X1 keep zb as int16
ZB_MIN, ZB_MAX = -(1 << 15), (1 << 15) - 1
# X1's forms (csrc/xsflood.cu `FloodForm`)
FLOOD_FORMS = ("lane_cta", "warps", "cluster")


def _kdilate(bits):
    return bits | (bits << 1) | (bits >> 1)


def _var_shift(bits, delta):
    """bits << delta with elementwise (possibly negative) delta, clamped
    to +-31. The words are int32: their low K bits equal those of the
    JAX package's uint32 words, and every flood step masks the rest."""
    d = torch.clamp(delta, -31, 31)
    return (bits << torch.clamp(d, min=0)) >> torch.clamp(-d, min=0)


def _shift2(a, dx: int, dy: int, fill: int):
    """out[:, x, y] = a[:, x + dx, y + dy] over a (B, Wx, Wy) batch, the
    edges filled."""
    out = torch.full_like(a, fill)
    X, Y = a.shape[1], a.shape[2]
    xs, xd = (slice(dx, X), slice(0, X - dx)) if dx >= 0 else \
        (slice(0, X + dx), slice(-dx, X))
    ys, yd = (slice(dy, Y), slice(0, Y - dy)) if dy >= 0 else \
        (slice(0, Y + dy), slice(-dy, Y))
    out[:, xd, yd] = a[:, xs, ys]
    return out


def _shift1(a, d: int):
    """out[..., j] = a[..., j + d] along the last axis, zero filled."""
    if d == 0:
        return a
    out = torch.zeros_like(a)
    if d > 0:
        out[..., :-d] = a[..., d:]
    else:
        out[..., -d:] = a[..., :d]
    return out


def _infill(r, sb):
    """In-word run fill: K bits need K - 1 adjacency passes."""
    for _ in range(K - 1):
        r = (r | _kdilate(r)) & sb
    return r


def _sweep_pass(r, secb, zb, axis: int, reverse: bool):
    """One directed sweep along `axis` (1 or 2 of the (B, Wx, Wy) words):
    each row pulls from the previous row's three neighbour columns,
    re-based by the zb delta, then fills within its section word."""
    if axis == 2:
        r, secb, zb = (t.transpose(1, 2) for t in (r, secb, zb))
    n = r.shape[1]
    # the previous row's zb in this row's frame, for the three dy
    zprev = torch.zeros_like(zb)
    if reverse:
        zprev[:, :-1] = zb[:, 1:]
    else:
        zprev[:, 1:] = zb[:, :-1]
    shifts = []
    for dy in (-1, 0, 1):
        d = torch.clamp(_shift1(zprev, dy) - zb, -31, 31)
        shifts.append((dy, torch.clamp(d, min=0), torch.clamp(-d, min=0)))
    out = torch.empty_like(r)
    prev = None
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        sb = secb[:, i]
        cand = r[:, i]
        if prev is not None:
            for dy, lsh, rsh in shifts:
                al = (_shift1(prev, dy) << lsh[:, i]) >> rsh[:, i]
                cand = cand | _kdilate(al)
        prev = _infill(cand & sb, sb)
        out[:, i] = prev
    return out.transpose(1, 2).contiguous() if axis == 2 else out


def _dilate_round(r, secb, nbrs):
    nxt = r | _kdilate(r)
    for dx, dy, delta in nbrs:
        nxt = nxt | _kdilate(_var_shift(_shift2(r, dx, dy, 0), delta))
    return nxt & secb


def _section_flood_plain(seed, secb, zb, rounds: int, method: str):
    """Plain torch version of kernel X1. Returns (kept, changed (B,) bool,
    rounds run per lane (B,) int32)."""
    B = seed.shape[0]
    if method == "sweep":
        r = _infill(seed, secb)

        def one_round(r):
            for axis in (1, 2):
                for rev in (False, True):
                    r = _sweep_pass(r, secb, zb, axis, rev)
            return r
    else:
        r = seed
        nbrs = [(dx, dy, _shift2(zb, dx, dy, 0) - zb)
                for dx in (-1, 0, 1) for dy in (-1, 0, 1) if dx or dy]

        def one_round(r):
            return _dilate_round(r, secb, nbrs)

    active = torch.ones(B, dtype=torch.bool, device=seed.device)
    run = torch.zeros(B, dtype=torch.int32, device=seed.device)
    changed = active
    for _ in range(int(rounds) + 1):
        nxt = one_round(r)
        run = run + active.to(torch.int32)
        changed = (nxt != r).flatten(1).any(dim=1)
        r = nxt
        active = active & changed
        if not bool(active.any()):
            break
    return r, changed, run


def check_zb(secb, zb) -> None:
    """Raise unless zb fits int16 wherever the section word is not 0 (the
    packed forms of X1 store it so; where the section word is 0 the word
    stays 0 and zb is never read). A caller whose zb may leave int16
    there checks with this before `section_flood`."""
    if zb.numel() == 0:
        return
    lo, hi = torch.aminmax(torch.where(secb != 0, zb, 0))
    if int(lo) < ZB_MIN or int(hi) > ZB_MAX:
        raise ValueError(
            f"section_flood: zb in [{int(lo)}, {int(hi)}] where the section "
            f"is not empty; X1 keeps zb as int16")


def section_flood_plan(Wx: int, Wy: int, method: str = "sweep"):
    """How X1 runs a (Wx, Wy) window on the current CUDA device: (form,
    CTAs a lane, whether the window lies in shared memory), the form one
    of FLOOD_FORMS ("warps": one CTA a lane of a warp per 32 columns, the
    packed window in shared memory; "cluster": one thread-block cluster a
    lane, each CTA a band of window rows; "lane_cta": one CTA a lane, in
    shared memory while it fits, else in device memory)."""
    if method not in _METHODS:
        raise ValueError(f"section_flood_plan: unknown method {method!r}")
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    form = kernels.lib().kt_xs_flood_plan(
        int(Wx), int(Wy), int(method == "sweep"), ctypes.byref(ctas),
        ctypes.byref(smem))
    if form < 0:
        raise ValueError(f"section_flood_plan: bad window ({Wx}, {Wy})")
    return FLOOD_FORMS[form], ctas.value, bool(smem.value)


def section_flood(seed, secb, zb, rounds: int, method: str):
    """Flood each lane's section from its seed word: seed, secb and zb are
    (B, Wx, Wy) int32 (K-bit words, seed within secb; zb within int16
    where secb is not 0: see `check_zb`). Returns (kept (B, Wx, Wy) int32,
    changed (B,) bool: the last round run changed a word, rounds run per
    lane (B,) int32)."""
    if method not in _METHODS:
        raise ValueError(f"section_flood: unknown method {method!r}")
    if seed.device.type == "cpu":
        return _section_flood_plain(seed, secb, zb, rounds, method)
    kernels.require_cuda(
        "section_flood", seed, secb, zb,
        dtypes=((torch.int32,),) * 3, shape=seed.shape)
    if seed.ndim != 3 or rounds < 0:
        raise ValueError("section_flood: needs (B, Wx, Wy) words and "
                         "rounds >= 0")
    B, Wx, Wy = seed.shape
    kept = torch.empty_like(seed)
    scratch = torch.empty_like(seed) if method == "dilate" else None
    changed = torch.empty(B, dtype=torch.int32, device=seed.device)
    run = torch.empty(B, dtype=torch.int32, device=seed.device)
    rc = kernels.lib().kt_xs_flood(
        kernels.ptr(seed), kernels.ptr(secb), kernels.ptr(zb),
        kernels.ptr(kept), kernels.ptr(scratch), kernels.ptr(changed),
        kernels.ptr(run), B, Wx, Wy, int(rounds), int(method == "sweep"),
        kernels.stream_ptr(seed.device))
    kernels.check(rc, "section_flood")
    kernels.LAUNCHES["section_flood"] += 1
    return kept, changed != 0, run

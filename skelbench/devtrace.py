"""Reading a `torch.profiler` trace of one chunk: the card's busy time as the
union of its operation intervals (kernels, copies and memsets; overlapping
streams count once), device time by operation name, and the card's idle
gaps by the program phase the host was in.

Events are plain tuples, so the arithmetic is tested without a card:
device events `(name, start_us, end_us)`, host ranges the same. The
profiler records the card alone (no host operations: their recording
would slow the host-bound parts it measures); the host ranges are the
program's phases on the Unix clock, the clock the profiler's timestamps
are given in.
"""

from __future__ import annotations

from collections import defaultdict


def union_seconds(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total * 1e-6


def gaps(intervals, lo, hi):
    """The idle (start_us, end_us) stretches of [lo, hi] outside the union
    of `intervals`."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def time_by_name(device_events):
    """{operation name: device seconds} (summed per name)."""
    out = defaultdict(float)
    for name, s, e in device_events:
        out[name] += (e - s) * 1e-6
    return dict(out)


def idle_by_phase(device_events, host_ranges, lo, hi):
    """{innermost host range open at the middle of each idle gap of
    [lo, hi]: idle seconds}; "-" where none is open."""
    out = defaultdict(float)
    ranges = sorted(host_ranges, key=lambda r: r[1])
    for a, b in gaps([(s, e) for _, s, e in device_events], lo, hi):
        mid = 0.5 * (a + b)
        best = None
        for name, s, e in ranges:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1]):
                best = (name, e - s)
        out[best[0] if best else "-"] += (b - a) * 1e-6
    return dict(out)


def events(prof):
    """The device events (kernels, copies, memsets) of a finished profiler
    as (name, start_us, end_us) tuples."""
    import torch

    dev = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() * 1e-3, ev.duration_ns() * 1e-3
        else:
            s, d = float(ev.start_us()), float(ev.duration_us())
        dev.append((ev.name(), s, s + d))
    return dev

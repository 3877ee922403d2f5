"""Lightweight phase timing and run counters.

A nestable phase timer and named counters: while collection is switched
on (`collect(True)`) they accumulate per-phase wall seconds and counters,
so a run can report its phase split as machine-readable numbers.
`phase(name, device=...)` synchronizes a CUDA device before starting and
stopping the clock, so queued kernels are charged to the phase that
launched them.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

_COLLECT = False
_STATS: Dict[str, float] = {}
_COUNTERS: Dict[str, int] = {}


def collect(on: bool = True) -> None:
    """Turn on in-memory accumulation of phase times and counters."""
    global _COLLECT
    _COLLECT = on


def reset_stats() -> None:
    _STATS.clear()
    _COUNTERS.clear()


def get_stats() -> dict:
    """{"phases": {name: seconds}, "counters": {name: n}} accumulated
    since the last reset_stats()."""
    return {"phases": dict(_STATS), "counters": dict(_COUNTERS)}


def count(name: str, n: int = 1) -> None:
    """Bump a named counter (recorded only while collecting)."""
    if not _COLLECT:
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def _sync(device) -> None:
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextmanager
def phase(name: str, device=None):
    """Time a phase; with a CUDA `device` the clock stops after the
    device has finished the phase's work."""
    if not _COLLECT:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        _STATS[name] = _STATS.get(name, 0.0) + time.perf_counter() - t0

"""The program's span tracer: spans, phases, counters and blocking reads.

While collection is on (`collect(True)`) the program records:

- spans: `span(name, **attrs)` around a step. Each span holds an id, the
  id of the innermost span open when it began (its parent), the id of the
  public call it belongs to (`entry`: one a `skeletonize` call), its name,
  its start and end from `time.time_ns()` (the Unix clock that
  torch.profiler gives its device events in) and a small dict of
  attributes. `spans()` returns them; `reset_stats()` clears them.
- phases: `phase(name, device)`, the span of a layer's stage. With a CUDA
  `device` a phase synchronizes it at both ends, so queued kernels are
  charged to the phase that launched them (`collect(True, sync=False)`
  records host intervals alone, without those synchronizes).
- counters: `count(name, n)`.
- blocking device reads: `host(t, read)`. Each read adds one to the
  counter `<phase>_syncs` and records its wait as a span `<phase>_wait`,
  where <phase> is the outermost open phase (`syncs` / `wait` outside
  every phase). A phase's own synchronizes are not counted.

`get_stats()` sums the spans' seconds by name ("phases", inclusive) beside
the counters. With collection off a span, a phase, a count and a read
each cost one flag test, and a read is the read alone.
"""

from __future__ import annotations

import functools
import itertools
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

_COLLECT = False
_SYNC = True
_NS: Dict[str, int] = {}            # summed nanoseconds of closed spans
_COUNTERS: Dict[str, int] = {}
_SPANS: List["_Span"] = []          # every span, in start order
_OPEN: List["_Span"] = []           # the open spans, innermost last
_TOP: Optional[tuple] = None        # (syncs counter, wait span) names
_CALL: Optional[int] = None
_SPAN_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)
_NULL = nullcontext()


def collect(on: bool = True, sync: bool = True) -> None:
    """Turn recording of spans and counters on or off. `sync=False`
    leaves out the phases' device synchronizes (host intervals only)."""
    global _COLLECT, _SYNC
    _COLLECT, _SYNC = on, sync


def reset_stats() -> None:
    _NS.clear()
    _COUNTERS.clear()
    _SPANS.clear()
    _OPEN.clear()


def get_stats() -> dict:
    """{"phases": {name: seconds}, "counters": {name: n}} accumulated
    since the last reset_stats(): the seconds of every span of a name,
    summed (a span's children included)."""
    return {"phases": {k: v * 1e-9 for k, v in _NS.items()},
            "counters": dict(_COUNTERS)}


def spans() -> List[dict]:
    """The spans recorded since the last reset_stats(), in start order:
    {"id", "parent", "call", "name", "start_ns", "end_ns", "attrs"}
    ("end_ns" None while open)."""
    return [{"id": s.id, "parent": s.parent, "call": s.call,
             "name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "attrs": dict(s.attrs)} for s in _SPANS]


def count(name: str, n: int = 1) -> None:
    """Bump a named counter (recorded only while collecting)."""
    if not _COLLECT:
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


class _Span:
    """One recorded interval; entered and left as a context manager."""

    __slots__ = ("id", "parent", "call", "name", "start_ns", "end_ns",
                 "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.id = next(_SPAN_IDS)
        self.parent = _OPEN[-1].id if _OPEN else None
        self.call = _CALL
        self.end_ns = None
        _SPANS.append(self)
        _OPEN.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if _OPEN and _OPEN[-1] is self:
            _OPEN.pop()
        _NS[self.name] = _NS.get(self.name, 0) + self.end_ns - self.start_ns
        return False


def span(name: str, **attrs):
    """A span around an inner step: it never synchronizes the device.
    A no-op context while collection is off."""
    return _Span(name, attrs) if _COLLECT else _NULL


def annotate(**attrs) -> None:
    """Add attributes to the innermost open span (while collecting)."""
    if _COLLECT and _OPEN:
        _OPEN[-1].attrs.update(attrs)


def _sync(device) -> None:
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextmanager
def phase(name: str, device=None):
    """A span around a layer's stage; with a CUDA `device` (and the
    default `collect(sync=True)`) it starts after the device has finished
    earlier work and ends after it has finished the phase's."""
    global _TOP
    if not _COLLECT:
        yield
        return
    outer = _TOP is None
    if outer:
        _TOP = (name + "_syncs", name + "_wait")
    try:
        if _SYNC:
            _sync(device)
        with _Span(name, {}):
            try:
                yield
            finally:
                if _SYNC:
                    _sync(device)
    finally:
        if outer:
            _TOP = None


def host(t, read=None):
    """A blocking device read: `read(t)`, or `t.cpu()` where `read` is
    None (`read` may be `bool`, `int`, `torch.nonzero` or any call that
    waits for the device). While collecting it is counted and its wait is
    a span, both under the outermost open phase."""
    if not _COLLECT:
        return t.cpu() if read is None else read(t)
    syncs, wait = _TOP or ("syncs", "wait")
    _COUNTERS[syncs] = _COUNTERS.get(syncs, 0) + 1
    with _Span(wait, {}):
        return t.cpu() if read is None else read(t)


def entry(name: str):
    """Decorator of a public call: while collecting, each call is a span
    `name` whose spans share a new call id."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            global _CALL
            if not _COLLECT:
                return fn(*args, **kwargs)
            outer, _CALL = _CALL, next(_CALL_IDS)
            try:
                with _Span(name, {}):
                    return fn(*args, **kwargs)
            finally:
                _CALL = outer
        return call
    return wrap

"""Axis-aligned bounding box helper (osteoid.Bbox equivalent).

Reference call sites: kimimaro/intake.py:454,
utility.py:152-158.
"""

from __future__ import annotations

import numpy as np


class Bbox:
    def __init__(self, minpt, maxpt):
        self.minpt = np.asarray(minpt, dtype=np.int64).copy()
        self.maxpt = np.asarray(maxpt, dtype=np.int64).copy()

    @classmethod
    def from_slices(cls, slices) -> "Bbox":
        minpt = [s.start if s.start is not None else 0 for s in slices]
        maxpt = [s.stop for s in slices]
        return cls(minpt, maxpt)

    def to_slices(self):
        return tuple(slice(int(a), int(b)) for a, b in zip(self.minpt, self.maxpt))

    def volume(self) -> int:
        return int(np.prod(np.maximum(self.maxpt - self.minpt, 0)))

    def size(self) -> np.ndarray:
        return self.maxpt - self.minpt

    def grow(self, amt: int) -> "Bbox":
        self.minpt -= amt
        self.maxpt += amt
        return self

    def clamp(self, lower, upper) -> "Bbox":
        self.minpt = np.clip(self.minpt, lower, upper)
        self.maxpt = np.clip(self.maxpt, lower, upper)
        return self

    def contains(self, pt) -> bool:
        pt = np.asarray(pt)
        return bool(np.all(pt >= self.minpt) and np.all(pt < self.maxpt))

    def clone(self) -> "Bbox":
        return Bbox(self.minpt, self.maxpt)

    def __repr__(self):
        return f"Bbox({self.minpt.tolist()}, {self.maxpt.tolist()})"

"""Wrappers the harness puts around entry points of the program while a run
needs them, and takes off again. They change no argument and no result.

- `KernelSpy` (the profiled chunk of a traced run): the operands of every
  B2 (`ops.gsweep.sweep0_dual`) and B4 (`ops.sweep.sweep_axis0_batched`,
  as `ops.geodesic` calls it) call, for their rooflines.
- `PhaseSpy` (the profiled chunk): the Unix-clock interval of each of
  the program's phases, so that the trace can say what the host was doing
  while the card idled.
"""

from __future__ import annotations

import contextlib


def _operand_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class KernelSpy:
    """Bytes each B2 and B4 call needs: every operand read once and every
    output written once, from the shapes and dtypes of the call (B2 with
    `kind="ball_rail"`: two float32 fields, the int32 cc ids, the float32
    node costs and a 1-byte mask in, two fields out: 25 bytes a voxel;
    `max2`: 20. B4: its float32 field, 1-byte mask, float32 node costs in
    node mode and the 4-byte gate words under a graph in, the field out:
    9, 13, 13 and 17 bytes a voxel)."""

    def __init__(self):
        from kimimaro_tpu_torch.ops import geodesic, gsweep

        self._gsweep, self._geodesic = gsweep, geodesic
        self._b2 = gsweep.sweep0_dual
        self._b4 = geodesic.sweep_axis0_batched
        self.calls = {"b2": [], "b4": []}

        def b2(da, db, cc, nodecost, okmask, anis_perm, kind, descending):
            ins = [da, db, cc] + ([nodecost, okmask] if kind == "ball_rail"
                                  else [])
            self.calls["b2"].append(_operand_bytes(ins)
                                    + _operand_bytes([da, db]))
            return self._b2(da, db, cc, nodecost, okmask, anis_perm, kind,
                            descending)

        def b4(d, ok, nc, anisotropy, node_mode, clamp_positive,
               descending=False, vg=None, bits9=None, gate=None,
               gate_bits9=None):
            words = gate if gate is not None else vg
            ins = [d, ok, nc if node_mode else None, words]
            self.calls["b4"].append(_operand_bytes(ins) + _operand_bytes([d]))
            return self._b4(d, ok, nc, anisotropy, node_mode, clamp_positive,
                            descending, vg=vg, bits9=bits9, gate=gate,
                            gate_bits9=gate_bits9)

        gsweep.sweep0_dual = b2
        geodesic.sweep_axis0_batched = b4

    def close(self):
        self._gsweep.sweep0_dual = self._b2
        self._geodesic.sweep_axis0_batched = self._b4


class PhaseSpy:
    def __init__(self):
        import time

        from kimimaro_tpu_torch import intake
        from kimimaro_tpu_torch.utils import profiling

        self._profiling, self._intake = profiling, intake
        self._phase = profiling.phase
        self.ranges = []        # (name, start_us, end_us)
        inner = self._phase

        @contextlib.contextmanager
        def phase(name, device=None):
            t0 = time.time_ns()
            try:
                with inner(name, device):
                    yield
            finally:
                self.ranges.append((name, t0 * 1e-3, time.time_ns() * 1e-3))

        profiling.phase = phase
        intake.phase = phase

    def close(self):
        self._profiling.phase = self._phase
        self._intake.phase = self._phase

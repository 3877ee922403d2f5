"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for Hopper (sm_90a) into
one shared library with a plain C interface under `build/kernels/` at the
repository root, and loaded with ctypes. Nothing here touches CUDA or the
library at import time, so the package imports on machines without a GPU;
the CPU code paths never call `lib()`.

Each kernel wrapper (ops.gsweep, ops.crop_argmax, ops.sweep, ops.xsfetch,
ops.xsslab, ops.fma, ops.voronoi, ops.stencils, ops.chase) adds one to its entry in `LAUNCHES` where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("gsweep.cu", "argmax.cu", "sweep.cu", "xsfetch.cu", "xsflood.cu",
            "fma.cu", "voronoi.cu", "gate.cu", "chase.cu")
_HEADERS = ("plane.cuh",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    # the sweeps' f32 operation order is part of their contract
    "--fmad=false",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# launches per kernel since the last reset (B1, B2, B3, B4, B5, B6, X1,
# F1, V1 and its lane-batched form, G1, C1); the forms gated by a voxel
# graph (B1, B4, B5, C1) and G1's CCL form count apart
LAUNCHES: Dict[str, int] = {
    "gsweep_sweep0": 0,
    "gsweep_sweep0_vg": 0,
    "gsweep_sweep0_dual": 0,
    "crop_argmax": 0,
    "sweep_axis0_batched": 0,
    "sweep_axis0_batched_vg": 0,
    "sweep_axis0": 0,
    "sweep_axis0_vg": 0,
    "fetch_secb": 0,
    "section_flood": 0,
    "fma_f32": 0,
    "voronoi_sweep": 0,
    "voronoi_sweep_batched": 0,
    "graph_into": 0,
    "graph_into_ccl": 0,
    "chase_batched": 0,
    "chase_batched_vg": 0,
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return _BUILD_DIR / f"libkimimaro_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the output of those that
    failed once all have ended."""
    procs = [subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> float:
    """Compile the kernels if the library for the current sources is not
    built yet: one nvcc per source, all started together, then one link.
    Returns the seconds spent compiling (0.0 when cached)."""
    out = _library_path()
    if out.exists():
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in _SOURCES]
    t0 = time.perf_counter()
    try:
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-I", _CSRC, "-o", o, _CSRC / s]
                 for s, o in zip(_SOURCES, objs))
        _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        build()
        so = ctypes.CDLL(str(_library_path()))
        p, i = ctypes.c_void_p, ctypes.c_int
        so.kt_gsweep_sweep0.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p,
                                        i, i, i, p]
        so.kt_gsweep_sweep0.restype = i
        so.kt_gsweep_sweep0_plan.argtypes = [i, i, i, i, i, p, p]
        so.kt_gsweep_sweep0_plan.restype = i
        so.kt_gsweep_sweep0_dual.argtypes = [p, p, p, p, p, p, p, p,
                                             i, i, i, p, i, i, p]
        so.kt_gsweep_sweep0_dual.restype = i
        so.kt_gsweep_dual_plan.argtypes = [i, i, i, p, p]
        so.kt_gsweep_dual_plan.restype = i
        so.kt_crop_argmax.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                      p, p, p, p, p]
        so.kt_crop_argmax.restype = i
        so.kt_sweep_axis0.argtypes = [p, p, p, p, p, p, i, i, i, p, p, i, i,
                                      i, p]
        so.kt_sweep_axis0.restype = i
        so.kt_sweep_axis0_plan.argtypes = [i, i, i, i, p, p]
        so.kt_sweep_axis0_plan.restype = i
        so.kt_sweep_axis0_batched.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              p, p, i, i, i, p]
        so.kt_sweep_axis0_batched.restype = i
        so.kt_sweep_axis0_batched_plan.argtypes = [i, i, i, i, i, p, p]
        so.kt_sweep_axis0_batched_plan.restype = i
        so.kt_xs_fetch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   ctypes.c_uint, ctypes.c_uint, p]
        so.kt_xs_fetch.restype = i
        so.kt_xs_flood.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        so.kt_xs_flood.restype = i
        so.kt_xs_flood_plan.argtypes = [i, i, i, p, p]
        so.kt_xs_flood_plan.restype = i
        f, ll = ctypes.c_float, ctypes.c_longlong
        so.kt_fma_f32_flat.argtypes = [p, f, i, p, f, i, p, f, i, i, p, ll,
                                       p]
        so.kt_fma_f32_flat.restype = i
        so.kt_fma_f32_strided.argtypes = [p, f, p, p, f, p, p, f, p, i, p,
                                          ll, p, p]
        so.kt_fma_f32_strided.restype = i
        so.kt_voronoi_sweep.argtypes = [p, p, p, p, p, p, p, i, i, i, p, i,
                                        p]
        so.kt_voronoi_sweep.restype = i
        so.kt_voronoi_plan.argtypes = [i, i, p, p]
        so.kt_voronoi_plan.restype = i
        so.kt_voronoi_lanes.argtypes = [p, p, p, p, p, p, i, p, p, i, p, i,
                                        p]
        so.kt_voronoi_lanes.restype = i
        so.kt_voronoi_lanes_limits.argtypes = [p, p]
        so.kt_voronoi_lanes_limits.restype = i
        so.kt_graph_into.argtypes = [p, p, p, ll, i, i, i, p, p]
        so.kt_graph_into.restype = i
        so.kt_chase_batched.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p,
                                        p]
        so.kt_chase_batched.restype = i
        _LIB = so
    return _LIB


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def costs_arg(costs9):
    """The nine step costs as a C float array (copied into the launch)."""
    return (ctypes.c_float * 9)(*[float(c) for _, c in costs9])


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors, dtypes=None, shape=None) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor on one
    device, of the shape `shape` and of a dtype in the matching `dtypes`
    entry."""
    dev = None
    for k, t in enumerate(tensors):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operand {k} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {k} is not contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: operand {k} has shape {tuple(t.shape)}, "
                f"expected {tuple(shape)}")
        if dtypes is not None and t.dtype not in dtypes[k]:
            raise TypeError(
                f"{name}: operand {k} has dtype {t.dtype}, "
                f"expected one of {dtypes[k]}")

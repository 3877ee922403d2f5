"""ctypes loader for the native host graph kernels (hostops.cpp).

The counterpart of kimimaro_tpu.native. The library is compiled with g++
at first use into `build/native/` at the repository root (named by a hash
of the source, as kimimaro_tpu_torch.kernels builds into
`build/kernels/`), never into the package directory. When it cannot be
built or loaded every function returns None and the callers in
kimimaro_tpu_torch.post take their pure-python route, which gives the same
result. `available()` says which route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lib = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libhostops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = _library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None

    lib.kt_find_cycle.restype = ctypes.c_long
    lib.kt_find_cycle.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
    ]
    lib.kt_distance_graph.restype = ctypes.c_long
    lib.kt_distance_graph.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    lib.kt_rle_encode.restype = ctypes.c_long
    lib.kt_rle_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_void_p, ctypes.c_long,
    ]
    lib.kt_bbox_ids.restype = ctypes.c_long
    lib.kt_bbox_ids.argtypes = [
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native route runs (the library built and loaded)."""
    return _load() is not None


def find_cycle(edges: np.ndarray) -> Optional[np.ndarray]:
    """Native cycle finder; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    m = edges.shape[0]
    cap = 2 * m + 3
    out = np.zeros(cap, dtype=np.int32)
    n = lib.kt_find_cycle(
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
    )
    if n < 0:
        return None
    return out[:n]


def bbox_ids(labels: np.ndarray, ids) -> Optional[dict]:
    """Single-pass bboxes of arbitrary label ids over the raw volume;
    {id: (mn (3,), mx (3,) inclusive)} for present ids, or None when the
    library is unavailable / dtype unsupported."""
    lib = _load()
    if lib is None:
        return None
    labels = np.asarray(labels)
    if labels.ndim != 3 or labels.dtype.kind not in "ui":
        return None
    labels = np.ascontiguousarray(labels)
    id_set = {int(i) for i in ids}
    if any(i < 0 for i in id_set):
        return None
    ids_arr = np.asarray(sorted(id_set), dtype=np.uint64)
    k = len(ids_arr)
    if k == 0:
        return {}
    out = np.empty((k, 6), dtype=np.int64)
    rc = lib.kt_bbox_ids(
        labels.ctypes.data_as(ctypes.c_void_p),
        labels.dtype.itemsize,
        labels.shape[0], labels.shape[1], labels.shape[2],
        ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return {
        int(i): (out[j, :3].copy(), out[j, 3:].copy())
        for j, i in enumerate(ids_arr)
        if out[j, 0] >= 0
    }


def create_distance_graph(vertices: np.ndarray, edges: np.ndarray):
    """Native distance supergraph; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    m = edges.shape[0]
    cap = 2 * m + 8
    uv = np.zeros(2 * cap, dtype=np.int64)
    d = np.zeros(cap, dtype=np.float64)
    n = lib.kt_distance_graph(
        vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vertices.shape[0],
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), m,
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if n < 0:
        return None
    return {
        (int(uv[2 * i]), int(uv[2 * i + 1])): float(d[i]) for i in range(n)
    }


def rle_encode(flat: np.ndarray, cap: int):
    """Single-pass native RLE (u8 lengths with >255 splits + values).
    Returns (lengths, values) or None when the library is unavailable,
    the dtype unsupported, or the run count exceeds `cap`."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat)
    esz = flat.dtype.itemsize
    if esz not in (1, 2, 4) or flat.dtype.kind not in "iub":
        return None
    lengths = np.empty(cap, dtype=np.uint8)
    values = np.empty(cap, dtype=flat.dtype)
    n = lib.kt_rle_encode(
        flat.ctypes.data_as(ctypes.c_void_p), flat.size, esz,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        values.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        return None
    return lengths[:n], values[:n]

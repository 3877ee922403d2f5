"""kimimaro_tpu_torch.skeletonize against kimimaro_tpu.skeletonize on the
global-engine fixtures of tests/test_gengine.py: equal vertices, edges and
radii. The port's global engine must trace the labels (not hand them
all back), a soma-sized label must take the crop engine, and a label with
more manual targets than the crop engine holds the host trace path."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

TEASAR = {
    "scale": 1.5,
    "const": 30,
    "pdrf_exponent": 4,
    "pdrf_scale": 100000,
    "soma_detection_threshold": 1e9,  # keep every label global-eligible
    "soma_acceptance_threshold": 1e9,
}


def _blob_volume(seed=0, shape=(40, 36, 30), n_seeds=6):
    """Several irregular 26-connected blobs (tests/test_gengine.py)."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, dtype=np.uint32)
    for lab in range(1, n_seeds + 1):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        noise = rng.rand(*shape) * 0.4
        m = (e + noise) < 1.0
        vol[m & (vol == 0)] = lab
    return vol


def _border_volume(seed):
    vol = _blob_volume(seed=seed)
    vol[:3] = 0
    vol[0, 10:20, 10:18] = 7  # touching the border -> border targets
    vol[1, 10:20, 10:18] = 7
    vol[2, 11:19, 11:17] = 7
    return vol


def _assert_same(a, b):
    assert set(a.keys()) == set(b.keys())
    for k in a:
        sa, sb = a[k], b[k]
        va = sa.vertices[np.lexsort(sa.vertices.T)]
        vb = sb.vertices[np.lexsort(sb.vertices.T)]
        np.testing.assert_array_equal(va, vb)

        def edge_set(s):
            v = s.vertices
            es = set()
            for e in s.edges:
                p, q = tuple(v[e[0]]), tuple(v[e[1]])
                es.add((min(p, q), max(p, q)))
            return es

        assert edge_set(sa) == edge_set(sb)
        ra = {tuple(v): r for v, r in zip(sa.vertices, sa.radii)}
        rb = {tuple(v): r for v, r in zip(sb.vertices, sb.radii)}
        assert ra == rb


def _run_both(vol, teasar, **kw):
    want = kimimaro_tpu.skeletonize(vol, teasar_params=teasar,
                                    anisotropy=(16, 16, 40),
                                    dust_threshold=10, **kw)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=teasar, anisotropy=(16, 16, 40),
            dust_threshold=10, device="cpu", **kw)
    finally:
        profiling.collect(False)
    return want, got, profiling.get_stats()["counters"]


@pytest.mark.parametrize("fix_borders", (False, True))
@pytest.mark.parametrize("seed", (1, 2))
def test_skeletonize_matches_jax(seed, fix_borders):
    vol = _border_volume(seed) if fix_borders else _blob_volume(seed)
    want, got, counters = _run_both(vol, TEASAR, fix_borders=fix_borders)
    assert len(got) >= 3
    assert counters["gengine_jobs"] >= 2
    _assert_same(want, got)


@pytest.mark.parametrize("case", ("fix_branching_false", "max_paths"))
def test_skeletonize_engine_options_match_jax(case):
    """The global engine without rail updates (ball-only relax) and with
    a max_paths cap per label."""
    if case == "fix_branching_false":
        vol, teasar, kw = _blob_volume(seed=3), TEASAR, dict(
            fix_branching=False)
    else:
        vol, teasar, kw = _blob_volume(seed=4), dict(TEASAR, max_paths=2), {}
    want, got, counters = _run_both(vol, teasar, fix_borders=False, **kw)
    assert counters["gengine_jobs"] >= 2
    _assert_same(want, got)


def test_skeletonize_leftover_label_takes_crop_engine():
    """A ball with a DBF max above the soma cut is not global-eligible:
    both packages trace it through their crop engine; the skeletons
    agree."""
    vol = _blob_volume(seed=1)
    x, y, z = np.ogrid[:40, :36, :30]
    vol[((x - 30) ** 2 + (y - 26) ** 2 + ((z - 21) * 0.5) ** 2) <= 49] = 9
    teasar = dict(TEASAR, soma_detection_threshold=80,
                  soma_acceptance_threshold=200)
    want, got, counters = _run_both(vol, teasar, fix_borders=True)
    assert counters["gengine_jobs"] >= 2
    assert counters["crop_engine_jobs"] >= 1
    assert counters["fallback_jobs"] == 0
    assert 9 in got
    _assert_same(want, got)


def test_skeletonize_leftover_label_takes_host_trace_path():
    """A label given more than 16 manual targets is held by neither
    engine: the crop engine hands it to the host trace path; the
    skeletons agree."""
    vol = _blob_volume(seed=1)
    lab = np.bincount(vol.ravel())[1:].argmax() + 1
    pts = np.argwhere(vol == lab)[::11][:17]
    want, got, counters = _run_both(
        vol, TEASAR, fix_borders=True,
        extra_targets_before=[tuple(int(c) for c in p) for p in pts])
    assert counters["gengine_jobs"] >= 2
    assert counters["crop_engine_jobs"] >= 1
    assert counters["fallback_jobs"] >= 1
    _assert_same(want, got)


def test_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        kimimaro_tpu_torch.skeletonize(_blob_volume(seed=1),
                                       dust_threshold=10, device="cuda")


def test_import_pulls_in_no_jax():
    code = ("import sys, kimimaro_tpu_torch, kimimaro_tpu_torch.gengine, "
            "kimimaro_tpu_torch.kernels\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('kimimaro_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

"""Every op function that kimimaro_tpu.ops exports, called the JAX way:
positional arguments in the JAX order, numpy inputs, and the bounded
forms (`rounds`, a small `max_rounds`, `connectivity=26`). The port's op
of the same name must take the same call and give the same values, bit
for bit, on the CPU."""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the JAX package's tests run it)
import torch

import kimimaro_tpu.ops as jops
import kimimaro_tpu_torch.ops as tops

torch.set_num_threads(1)

ANIS = (1.0, 2.0, 1.5)
ALL26 = np.uint32((1 << 26) - 1)


def _labels(seed=0, shape=(12, 10, 9)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 3, size=shape) * 1000003).astype(np.uint32)


def _case():
    """Queue C 11's first input: a random open mask with its first voxel
    set, one source there and a random voxel graph."""
    rng = np.random.RandomState(0)
    ok = rng.rand(12, 10, 9) > 0.3
    ok[0, 0, 0] = True
    init = np.full(ok.shape, np.inf, dtype=np.float32)
    init[0, 0, 0] = 0.0
    vg = rng.randint(0, 2**26, size=ok.shape).astype(np.uint32)
    return ok, init, vg


def _serpentine():
    """A 40 x 40 x 1 serpentine: even rows open, odd rows open at one end
    cell each, alternating sides, so the one path is 820 voxels long."""
    ok = np.zeros((40, 40, 1), dtype=bool)
    ok[0::2] = True
    for r in range(1, 40, 2):
        ok[r, 39 if (r // 2) % 2 == 0 else 0] = True
    init = np.full(ok.shape, np.inf, dtype=np.float32)
    init[0, 0, 0] = 0.0
    return ok, init


def _pair(fn_name, *args, **kw):
    want = getattr(jops, fn_name)(*args, **kw)
    got = getattr(tops, fn_name)(*args, device="cpu", **kw)
    return want, got


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    if isinstance(want, dict):  # a mapping of ids
        assert got == want
        return
    w = np.asarray(want)
    g = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    if w.ndim == 0:  # a count
        assert int(g) == int(w)
        return
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    assert g.shape == w.shape
    if g.dtype.kind == "f":
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    else:
        np.testing.assert_array_equal(g, w)


def _run(name):
    ok, init, vg = _case()
    labels = _labels()
    rng = np.random.RandomState(4)
    dbf = rng.uniform(0.5, 3.0, size=ok.shape).astype(np.float32)
    nc = rng.uniform(0.1, 2.0, size=ok.shape).astype(np.float32)
    path = np.array([(0, 0, 0), (3, 4, 5), (11, 9, 8)], dtype=np.int64)
    if name == "connected_components":
        return _pair(name, labels)
    if name == "renumber_cc":
        raw = np.asarray(jops.connected_components(labels))
        return _pair(name, raw, labels)
    if name == "edt_transform":
        return _pair(name, labels, ANIS, True)
    if name == "edtsq":
        return _pair(name, labels, ANIS, False, vg)
    if name == "fill_voids":
        vol = np.zeros((9, 9, 9), dtype=bool)
        vol[1:8, 1:8, 1:8] = True
        vol[3:6, 3:6, 3:6] = False
        vol[4, 4, 0:4] = False
        return _pair(name, vol, True)
    if name == "distance_field":
        return _pair(name, ok, init, ANIS, nc, False, 4096, vg)
    if name == "euclidean_distance_field":
        return _pair(name, ok, (0, 0, 0), ANIS, False, vg)
    if name == "flood_fill":
        seed = np.zeros(ok.shape, dtype=bool)
        seed[0, 0, 0] = True
        return _pair(name, seed, ok, 26)
    if name == "invalidation_ball":
        return _pair(name, ok, dbf, path, 1.5, 0.5, ANIS, vg)
    if name == "invalidation_cube":
        return _pair(name, labels, dbf, path, 1.5, 0.5, ANIS)
    if name == "parent_field":
        d = np.asarray(jops.distance_field(ok, init, ANIS))
        return _pair(name, d, ok, ANIS, None, vg)
    if name == "voronoi_feature_field":
        return _pair(name, ok, path, ANIS, 4096)
    raise AssertionError(name)


OP_FUNCTIONS = [n for n in jops.__all__
                if callable(getattr(jops, n))
                and not isinstance(getattr(jops, n), type(jops))]


def test_every_exported_op_function_is_covered():
    assert sorted(OP_FUNCTIONS) == sorted(
        ["connected_components", "renumber_cc", "edt_transform", "edtsq",
         "fill_voids", "distance_field", "euclidean_distance_field",
         "flood_fill", "invalidation_ball", "invalidation_cube",
         "parent_field", "voronoi_feature_field"])
    assert set(jops.__all__) == set(tops.__all__)


@pytest.mark.parametrize("name", sorted(
    ["connected_components", "renumber_cc", "edt_transform", "edtsq",
     "fill_voids", "distance_field", "euclidean_distance_field",
     "flood_fill", "invalidation_ball", "invalidation_cube",
     "parent_field", "voronoi_feature_field"]))
def test_op_takes_the_jax_call_with_numpy_input(name):
    want, got = _run(name)
    _equal(got, want)


def test_distance_field_returns_the_unconverged_field_at_max_rounds():
    ok, init = _serpentine()
    want = np.asarray(jops.distance_field(ok, init, (1, 1, 1), None, False,
                                          7))
    got = tops.distance_field(ok, init, (1, 1, 1), None, False, 7,
                              device="cpu")
    assert 0 < int(np.isfinite(want).sum()) < int(ok.sum())
    _equal(got, want)


@pytest.mark.parametrize("rounds", (0, 2, 5))
def test_distance_field_bounded_rounds_match_jax(rounds):
    ok, init = _serpentine()
    want = jops.distance_field(ok, init, (1.0, 1.0, 1.0), None, False, 4096,
                               None, rounds, "exact")
    got = tops.distance_field(ok, init, (1.0, 1.0, 1.0), None, False, 4096,
                              None, rounds, "exact", device="cpu")
    _equal(got, want)


@pytest.mark.parametrize("connectivity,rounds", [(6, None), (26, None),
                                                 (6, 3), (26, 3)])
def test_flood_fill_connectivity_and_rounds_match_jax(connectivity, rounds):
    ok, _, _ = _case()
    seed = np.zeros(ok.shape, dtype=bool)
    seed[0, 0, 0] = True
    want = jops.flood_fill(seed, ok, connectivity, rounds)
    got = tops.flood_fill(seed, ok, connectivity, rounds, device="cpu")
    _equal(got, want)


def test_connected_components_takes_wide_and_narrow_labels():
    labels = _labels().astype(np.int64) * 4099  # values beyond 2^32
    want = np.asarray(jops.connected_components(labels))
    got = tops.connected_components(labels, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    small = (_labels() != 0).astype(np.uint8)
    np.testing.assert_array_equal(
        tops.connected_components(torch.from_numpy(small)).numpy(),
        np.asarray(jops.connected_components(small)))

"""The host trace path's geodesic fields (ops.geodesic, relaxed by kernel
B5's plain version) against the JAX package on small non-cubic anisotropic
crops, bit for bit.

The port builds the three swept layouts of the ok mask and the node costs
once per field and moves only the field per sweep; the results must stay
those of kimimaro_tpu.ops.geodesic, which moves all three every sweep. One
crop has an axis of length 1, whose sweeps `_sweep` skips.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the JAX package's tests run it)
import torch

from kimimaro_tpu.ops import geodesic as jgeo
from kimimaro_tpu_torch.ops import geodesic as tgeo

torch.set_num_threads(1)

# (shape, anisotropy, seed)
CROPS = {
    "wide": ((20, 13, 9), (16.0, 16.0, 40.0), 0),
    "tall": ((7, 22, 15), (4.0, 9.0, 2.5), 1),
    "flat": ((1, 18, 11), (16.0, 16.0, 40.0), 2),
}


def _crop(name):
    """A random mask of a crop (about three quarters set), a source voxel
    in it and positive node costs."""
    shape, anis, seed = CROPS[name]
    rng = np.random.RandomState(seed)
    ok = rng.rand(*shape) < 0.75
    src = tuple(int(c) for c in np.argwhere(ok)[len(np.argwhere(ok)) // 3])
    nc = np.where(ok, rng.rand(*shape) * 4 + 0.1, np.inf).astype(np.float32)
    return ok, src, nc, anis, rng


def _node_fields(ok, src, nc, anis):
    init = np.full(ok.shape, np.inf, dtype=np.float32)
    init[src] = 0.0
    want = jgeo.distance_field(ok, init, anis, node_cost=nc)
    got = tgeo.distance_field(torch.from_numpy(ok), torch.from_numpy(init),
                              anis, node_cost=torch.from_numpy(nc))
    return np.asarray(want), got


@pytest.mark.parametrize("crop", sorted(CROPS))
@pytest.mark.parametrize("field", ("euclid", "node", "parent_node",
                                   "parent_euclid", "ball"))
def test_host_geodesic_field_matches_jax(field, crop):
    ok, src, nc, anis, rng = _crop(crop)
    ok_t = torch.from_numpy(ok)
    if field in ("euclid", "parent_euclid"):
        want = np.asarray(jgeo.euclidean_distance_field(ok, src, anis))
        got = tgeo.euclidean_distance_field(ok_t, src, anis)
        assert np.isfinite(want).sum() > 1
        if field == "parent_euclid":
            want = np.asarray(jgeo.parent_field(want, ok, anis))
            got = tgeo.parent_field(got, ok_t, anis)
    elif field in ("node", "parent_node"):
        want, got = _node_fields(ok, src, nc, anis)
        assert np.isfinite(want).sum() > 1
        if field == "parent_node":
            want = np.asarray(jgeo.parent_field(want, ok, anis, node_cost=nc))
            got = tgeo.parent_field(got, ok_t, anis,
                                    node_cost=torch.from_numpy(nc))
    else:
        dbf = np.where(ok, rng.rand(*ok.shape) * 60, 0).astype(np.float32)
        path = np.argwhere(ok)[::7][:5]
        want = np.asarray(jgeo.invalidation_ball(ok, dbf, path, 1.5, 20.0,
                                                 anis))
        got = tgeo.invalidation_ball(ok_t, torch.from_numpy(dbf), path, 1.5,
                                     20.0, anis)
        assert 0 < want.sum() < ok.sum()
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)

"""The port's host trace path (trace.trace, the leftover-label path of
skeletonize) against kimimaro_tpu.trace.trace on the same label crops:
equivalent skeletons and equal radii per vertex."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kimimaro_tpu import trace as jtrace
from kimimaro_tpu.ops import edt as jedt
from kimimaro_tpu_torch import trace as ttrace
from kimimaro_tpu_torch.skeleton import Skeleton

torch.set_num_threads(1)


def _dbf(labels, anisotropy):
    d = jedt.edt(labels, anisotropy)
    return np.asarray(jnp.where(jnp.asarray(labels) != 0, d, 0.0))


def _assert_same(a, b):
    assert not b.empty()
    assert Skeleton.equivalent(a, b)
    ra = {tuple(v): r for v, r in zip(a.vertices.astype(int), a.radii)}
    for v, r in zip(b.vertices.astype(int), b.radii):
        assert ra[tuple(v)] == r


@pytest.mark.parametrize("fix_branching", (True, False))
def test_trace_matches_jax_on_l_tube(fix_branching):
    labels = np.zeros((40, 40, 8), dtype=np.uint8)
    labels[4:36, 18:22, 2:6] = 1
    labels[18:22, 4:36, 2:6] = 1
    params = dict(scale=1.5, const=4, pdrf_scale=100000, pdrf_exponent=4,
                  soma_detection_threshold=1100,
                  soma_acceptance_threshold=3500)
    dbf = _dbf(labels, (1, 1, 1))
    want = jtrace.trace(labels, dbf, anisotropy=(1, 1, 1),
                        fix_branching=fix_branching, **params)
    got = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1),
                       fix_branching=fix_branching, device="cpu", **params)
    _assert_same(want, got)


def test_trace_matches_jax_in_soma_mode():
    """A hollow ball with a neurite: hole fill + re-EDT, soma root, root
    ball invalidation and soma-radius culling."""
    n = 20
    g = np.indices((n, n, n)).transpose(1, 2, 3, 0)
    r2 = np.sum((g - 8) ** 2, axis=-1)
    labels = ((r2 <= 49) & (r2 > 4)).astype(np.uint8)
    labels[12:20, 7:10, 7:10] = 1
    params = dict(scale=1.5, const=2, pdrf_scale=100000, pdrf_exponent=4,
                  soma_detection_threshold=3, soma_acceptance_threshold=5,
                  soma_invalidation_scale=0.5, soma_invalidation_const=0)
    dbf = _dbf(labels, (1, 1, 1))
    want = jtrace.trace(labels, dbf, anisotropy=(1, 1, 1), **params)
    got = ttrace.trace(labels, dbf, anisotropy=(1, 1, 1), device="cpu",
                       **params)
    _assert_same(want, got)


def test_trace_with_manual_targets_and_root():
    labels = np.zeros((30, 12, 10), dtype=np.uint8)
    labels[2:28, 3:9, 2:8] = 1
    params = dict(scale=1.5, const=4, pdrf_scale=100000, pdrf_exponent=4)
    dbf = _dbf(labels, (16, 16, 40))
    kw = dict(anisotropy=(16, 16, 40), root=(2, 5, 4),
              manual_targets_before=[(27, 6, 5)],
              manual_targets_after=[(14, 3, 2)], **params)
    want = jtrace.trace(labels, dbf, **kw)
    got = ttrace.trace(labels, dbf, device="cpu", **kw)
    _assert_same(want, got)

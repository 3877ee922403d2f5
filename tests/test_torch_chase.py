"""The rail-field pointer chase of the port (the host `_chase` and the
lane-batched `chase_batched`) against the JAX package's
`fused_trace._chase` under jax.jit and jax.vmap: equal paths, lengths and
rail flags, including walks that leave the crop, where JAX's index rule
(a negative index counts from the end once, then clamps) decides what the
walk reads."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kimimaro_tpu.ops import fused_trace
from kimimaro_tpu_torch.ops.chase import _chase, chase_batched

torch.set_num_threads(1)

SHAPE = (7, 6, 5)  # crop; the fields are padded by one voxel
L = 14


def _cases():
    """(name, padded rail field, start) of walks on one padded shape."""
    rng = np.random.RandomState(3)
    cases = []

    d = rng.randint(0, 6, size=SHAPE).astype(np.float32)
    d[rng.rand(*SHAPE) < 0.2] = np.inf
    cases.append(("rail_in_crop",
                  np.pad(d, 1, constant_values=np.inf), (6, 5, 4)))

    d = np.full(SHAPE, np.inf, np.float32)
    d[3, 3, 2] = 5.0
    cases.append(("no_rail_over_inf",
                  np.pad(d, 1, constant_values=np.inf), (3, 3, 2)))

    # finite everywhere, padding included, falling toward x = -1: the walk
    # leaves the crop through finite values, and its window then wraps
    g = np.indices(np.array(SHAPE) + 2).astype(np.float32)
    d_pad = (100.0 + 10.0 * g[0] + rng.rand(*g.shape[1:]) * 3).astype(
        np.float32)
    d_pad[-3:, :, :] = 50.0 + rng.rand(3, *d_pad.shape[1:]).astype(
        np.float32)
    cases.append(("leaves_through_finite", d_pad, (2, 3, 2)))

    # starts in an all-inf corner and walks out; the wrapped reads find a
    # rail at the crop's far corner
    d = np.full(SHAPE, np.inf, np.float32)
    d[-2:, -2:, -2:] = 2.0
    d[-2, -2, -2] = 1.0
    d[-1, -1, -1] = 0.0
    cases.append(("rail_through_wrap",
                  np.pad(d, 1, constant_values=np.inf), (0, 0, 0)))
    return cases


CASES = _cases()


def _jax_chase(d_pad, start):
    fn = jax.jit(lambda dp, st: fused_trace._chase(dp, st, L))
    p, n, r = fn(jnp.asarray(d_pad), jnp.asarray(start, dtype=jnp.int32))
    return np.asarray(p), int(n), bool(r)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_host_chase_matches_jax(case):
    _, d_pad, start = CASES[case]
    wp, wl, wr = _jax_chase(d_pad, start)
    path, length, reached = _chase(d_pad, start, L)
    assert (length, reached) == (wl, wr)
    np.testing.assert_array_equal(path, wp)


def test_batched_chase_matches_jax():
    d_pad = np.stack([c[1] for c in CASES])
    starts = np.array([c[2] for c in CASES])
    wp, wl, wr = jax.vmap(lambda dp, st: fused_trace._chase(dp, st, L))(
        jnp.asarray(d_pad), jnp.asarray(starts, dtype=jnp.int32))
    path, plen, reached = chase_batched(torch.from_numpy(d_pad),
                                        torch.from_numpy(starts), L)
    np.testing.assert_array_equal(path.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(reached.numpy(), np.asarray(wr))


def test_walks_leave_the_crop():
    """The fixture exercises the wrap rule: two walks step outside the
    crop, one of them over finite values only."""
    for name in ("leaves_through_finite", "rail_through_wrap"):
        _, d_pad, start = CASES[[c[0] for c in CASES].index(name)]
        wp, wl, _ = _jax_chase(d_pad, start)
        assert (wp[:wl] < 0).any(), name
        if name == "leaves_through_finite":
            assert np.isfinite(d_pad).all()

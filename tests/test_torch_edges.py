"""The plain versions of B4 and X1 at the edge shapes of the kernels' shape
rules (ops.sweep.sweep_axis0_batched_plan, ops.xsslab.section_flood_plan)
against the JAX package, bit for bit: one plane, one row, one column, odd
widths, strips of one row, windows of one cell, row and column windows.
The kernels themselves meet these shapes on the card (tests/
test_torch_gpu.py, chip_smoke.py phase 3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kimimaro_tpu.ops import pallas_sweep
from kimimaro_tpu.ops import xsslab as jxsslab
from kimimaro_tpu.ops.stencils import GRAPH_BITS
from kimimaro_tpu_torch.ops import sweep as tsweep
from kimimaro_tpu_torch.ops import xsslab as txsslab

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)


@pytest.fixture
def interpret():
    prev = pallas_sweep.INTERPRET
    pallas_sweep.INTERPRET = True
    yield
    pallas_sweep.INTERPRET = prev


# (B, n, H, W): n = 1, H = 1, W = 1, odd widths, a strip of one row a CTA
# (H = 7 over 7 CTAs), more lanes than one wave of clusters
B4_EDGES = ((1, 1, 9, 9), (3, 5, 1, 7), (5, 9, 7, 1), (2, 4, 33, 17),
            (1, 3, 1, 1), (9, 6, 7, 3))


@pytest.mark.parametrize("graph", (False, True))
@pytest.mark.parametrize("shape", B4_EDGES)
def test_sweep_axis0_batched_edges_match_pallas_interpret(interpret, shape,
                                                          graph):
    rng = np.random.RandomState(sum(shape))
    d = np.where(rng.rand(*shape) < 0.3, rng.rand(*shape) * 10 - 5,
                 np.inf).astype(np.float32)
    ok = rng.rand(*shape) < 0.8
    nc = (rng.rand(*shape) * 3).astype(np.float32)
    vg = bits9 = None
    if graph:
        vg = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(
            np.uint32)
        bits9 = tuple(GRAPH_BITS[(-dy, -dz, -1)] for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1))
    for node_mode, clamp, desc in ((True, False, False), (False, True, True)):
        want = np.asarray(pallas_sweep.sweep_axis0_batched(
            jnp.asarray(d), jnp.asarray(ok), jnp.asarray(nc), ANIS,
            node_mode, clamp, descending=desc,
            vg=None if vg is None else jnp.asarray(vg), bits9=bits9))
        got = tsweep.sweep_axis0_batched(
            torch.from_numpy(d), torch.from_numpy(ok), torch.from_numpy(nc),
            ANIS, node_mode, clamp, descending=desc,
            vg=None if vg is None else torch.from_numpy(vg.view(np.int32)),
            bits9=bits9)
        np.testing.assert_array_equal(got.numpy(), want)


def _windows(seed, B, Wx, Wy, density=0.7):
    rng = np.random.RandomState(seed)
    secb = (rng.randint(0, 32, size=(B, Wx, Wy))
            & rng.randint(0, 32, size=(B, Wx, Wy))).astype(np.int32)
    secb[rng.rand(B, Wx, Wy) > density] = 0
    ii, jj = np.meshgrid(np.arange(Wx), np.arange(Wy), indexing="ij")
    zb = np.floor(rng.uniform(-1, 1, (B, 1, 1)) * ii
                  + rng.uniform(-1, 1, (B, 1, 1)) * jj
                  + rng.uniform(0, 1, (B, 1, 1))).astype(np.int32) - 2
    seed_w = np.zeros_like(secb)
    seed_w[:, Wx // 2, Wy // 2] = 31
    return seed_w & secb, secb, zb


# (Wx, Wy): one cell, one row, one column, a band of one row a CTA (the
# cluster form's Bx = 1), odd sizes around a warp's 32 columns
X1_EDGES = ((1, 1), (1, 40), (40, 1), (2, 33), (33, 31), (64, 63), (17, 64))


@pytest.mark.parametrize("shape", X1_EDGES)
def test_section_flood_sweep_edges_match_jax(shape):
    Wx, Wy = shape
    for rounds in (0, 3):
        seed, secb, zb = _windows(Wx * 7 + Wy + rounds, 3, Wx, Wy)
        fn = jax.vmap(lambda s, b, z: jxsslab._sweep_rounds(s, b, z, rounds))
        wk, wc = fn(jnp.asarray(seed, jnp.uint32),
                    jnp.asarray(secb, jnp.uint32), jnp.asarray(zb))
        kept, changed, run = txsslab.section_flood(
            torch.from_numpy(seed), torch.from_numpy(secb),
            torch.from_numpy(zb), rounds, "sweep")
        np.testing.assert_array_equal(kept.numpy().astype(np.uint32),
                                      np.asarray(wk))
        np.testing.assert_array_equal(changed.numpy(), np.asarray(wc))
        assert (run.numpy() <= rounds + 1).all()

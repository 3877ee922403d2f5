"""The port's relax drivers, CCL, EDT, geodesic fields and hole filling
against the JAX package on the same seeded inputs.

Everything here is deterministic integer or f32 arithmetic in the same
operation order, so equality is exact: the EDT's final square root is
correctly rounded on both sides (float64 root rounded once in the port,
XLA's f32 root on the CPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kimimaro_tpu.ops import ccl as jccl
from kimimaro_tpu.ops import edt as jedt
from kimimaro_tpu.ops import fill as jfill
from kimimaro_tpu.ops import geodesic as jgeo
from kimimaro_tpu.ops import gsweep as jgsweep
from kimimaro_tpu_torch.ops import ccl as tccl
from kimimaro_tpu_torch.ops import edt as tedt
from kimimaro_tpu_torch.ops import fill as tfill
from kimimaro_tpu_torch.ops import geodesic as tgeo
from kimimaro_tpu_torch.ops import gsweep as tgsweep

torch.set_num_threads(1)

ANIS = (16.0, 16.0, 40.0)


def _blobs(seed=7, shape=(16, 14, 12)):
    """Three irregular labels (boundary-carved boxes) in a small volume."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, dtype=np.int32)
    boxes = {1: np.s_[1:7, 1:7, 1:6], 2: np.s_[8:15, 2:10, 2:10],
             3: np.s_[2:6, 8:13, 5:11]}
    for lab, sl in boxes.items():
        vol[sl] = lab
        m = vol[sl]
        carve = rng.rand(*m.shape) < 0.25
        carve[1:-1, 1:-1, 1:-1] = False
        m[carve] = 0
    return vol


def _sources(vol, value, which=0):
    d0 = np.full(vol.shape, np.inf, dtype=np.float32)
    for lab in (1, 2, 3):
        d0[tuple(np.argwhere(vol == lab)[which])] = value
    return d0


def _views(vol):
    return jgsweep.MaskViews(jnp.asarray(vol)), \
        tgsweep.MaskViews(torch.from_numpy(vol))


@pytest.mark.parametrize("mode", ("euclid", "node", "maxflood"))
def test_relax_full_matches_jax(mode):
    vol = _blobs()
    rng = np.random.RandomState(1)
    jv, tv = _views(vol)
    nc = (np.where(vol > 0, rng.rand(*vol.shape) * 5, np.inf)
          .astype(np.float32) if mode == "node" else None)
    if mode == "maxflood":
        d0 = np.where(vol > 0, rng.rand(*vol.shape), -np.inf)
        d0 = d0.astype(np.float32)
    else:
        d0 = _sources(vol, 0.0)
    want, wmask = jgsweep.relax_full(
        jnp.asarray(d0), jv, None if nc is None else jgsweep.MaskViews(
            jnp.asarray(nc)), None, ANIS, 2, mode=mode, return_mask=True)
    got, gmask = tgsweep.relax_full(
        torch.from_numpy(d0), tv, None if nc is None else tgsweep.MaskViews(
            torch.from_numpy(nc)), None, ANIS, 2, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("conv", ("exact", "reach", "negative"))
def test_relax_rounds_batched_matches_vmapped_jax(conv):
    """relax_rounds_batched equals relax_rounds_batchable under jax.vmap:
    values and per-lane convergence flags, for a field that converges in
    the rounds given and one that does not (node mode for "exact",
    euclid otherwise; a clamped ball for "negative")."""
    rng = np.random.RandomState(21)
    B, shape = 3, (9, 8, 7)
    ok = rng.rand(B, *shape) < 0.85
    d = np.full((B,) + shape, np.inf, dtype=np.float32)
    for b in range(B):
        s = tuple(rng.randint(0, n) for n in shape)
        d[(b,) + s] = -60.0 if conv == "negative" else 0.0
        ok[(b,) + s] = True
    ok[2, :, 3, :] = False  # lane 2 winds: it needs more rounds
    ok[2, 8, 3, :] = True
    ok[2, 0, 5, :] = False
    nc = (rng.rand(B, *shape) * 2 + 0.1).astype(np.float32)
    node = conv == "exact"
    clamp = conv == "negative"
    for rounds in (0, 1, 3):
        want, wconv = jax.vmap(
            lambda dd, oo, nn: jgeo.relax_rounds_batchable(
                dd, oo, nn if node else None, ANIS, rounds,
                clamp_positive=clamp, conv=conv))(
            jnp.asarray(d), jnp.asarray(ok), jnp.asarray(nc))
        got, gconv = tgeo.relax_rounds_batched(
            torch.from_numpy(d), torch.from_numpy(ok),
            torch.from_numpy(nc) if node else None, ANIS, rounds,
            clamp_positive=clamp, conv=conv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gconv.numpy(), np.asarray(wconv))


def _ball_rail_inputs(vol):
    rng = np.random.RandomState(3)
    valid = ((rng.rand(*vol.shape) < 0.8) & (vol > 0)).astype(np.uint8)
    pdrf = np.where(vol > 0, rng.rand(*vol.shape) * 9, np.inf)
    pdrf = pdrf.astype(np.float32)
    ball0 = np.full(vol.shape, np.inf, dtype=np.float32)
    rail0 = np.full(vol.shape, np.inf, dtype=np.float32)
    for lab in (1, 2, 3):
        p = np.argwhere(vol == lab)
        ball0[tuple(p[1])] = -70.0
        valid[tuple(p[1])] = 1
        rail0[tuple(p[-1])] = 0.0
        pdrf[tuple(p[-1])] = 0.0
    return valid, pdrf, ball0, rail0


@pytest.mark.parametrize("rounds", (1, 4))
def test_relax_escalated_dual_ball_rail_matches_jax(rounds):
    """The fused ball+rail relax (B2 plain version) equals the JAX
    package's escalated relax per field, masks included."""
    vol = _blobs()
    valid, pdrf, ball0, rail0 = _ball_rail_inputs(vol)
    jv, tv = _views(vol)
    want = jgsweep.relax_escalated_dual(
        jnp.asarray(ball0), jnp.asarray(rail0), jv,
        jgsweep.MaskViews(jnp.asarray(pdrf)),
        jgsweep.MaskViews(jnp.asarray(valid)), ANIS, rounds,
        kind="ball_rail", extra_stages=2, extra_rounds=1)
    got = tgsweep.relax_escalated_dual(
        torch.from_numpy(ball0), torch.from_numpy(rail0), tv,
        tgsweep.MaskViews(torch.from_numpy(pdrf)),
        tgsweep.MaskViews(torch.from_numpy(valid)), ANIS, rounds,
        kind="ball_rail", extra_stages=2, extra_rounds=1)
    for w, g in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_relax_full_dual_max2_matches_jax():
    vol = _blobs()
    rng = np.random.RandomState(4)
    a0 = np.where(vol > 0, rng.rand(*vol.shape), -np.inf).astype(np.float32)
    b0 = np.where(vol > 0, rng.rand(*vol.shape) * 7, -np.inf)
    b0 = b0.astype(np.float32)
    jv, tv = _views(vol)
    want = jgsweep.relax_full_dual(jnp.asarray(a0), jnp.asarray(b0), jv, None,
                                   None, ANIS, 2, kind="max2")
    got = tgsweep.relax_full_dual(torch.from_numpy(a0), torch.from_numpy(b0),
                                  tv, None, None, ANIS, 2, kind="max2")
    for w, g in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_relax_escalated_clamped_ball_matches_jax():
    vol = _blobs()
    valid, _, ball0, _ = _ball_rail_inputs(vol)
    jv, tv = _views(vol)
    want = jgsweep.relax_escalated(
        jnp.asarray(ball0), jv, None, jgsweep.MaskViews(jnp.asarray(valid)),
        ANIS, 1, mode="euclid", clamp_positive=True, conv="negative",
        extra_stages=3, extra_rounds=1)
    got = tgsweep.relax_escalated(
        torch.from_numpy(ball0), tv, None,
        tgsweep.MaskViews(torch.from_numpy(valid)), ANIS, 1, mode="euclid",
        clamp_positive=True, conv="negative", extra_stages=3, extra_rounds=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ccl_volume():
    rng = np.random.RandomState(11)
    vol = np.zeros((22, 17, 13), dtype=np.uint32)
    vol[2:9, 2:9, 2:7] = 7
    vol[2:9, 2:9, 8:12] = 7          # same label, separate component
    vol[12:20, 3:12, 3:12] = 0x80000001  # high bit set
    vol[1:21, 13:16, 1:12] = 5
    keep = rng.rand(*vol.shape) >= 0.1
    return np.where(keep, vol, 0).astype(np.uint32)


def test_connected_components_compact_and_label_info_match_jax():
    vol = _ccl_volume()
    labels_t = torch.from_numpy(vol.view(np.int32))
    raw_j = jccl.connected_components(jnp.asarray(vol))
    raw_t = tccl.connected_components(labels_t)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))

    cc_j, n_j, pre_j = jccl.compact_cc(raw_j)
    cc_t, n_t, pre_t = tccl.compact_cc(raw_t)
    assert n_t == n_j
    np.testing.assert_array_equal(cc_t.numpy(), np.asarray(cc_j))
    np.testing.assert_array_equal(pre_t.numpy(), np.asarray(pre_j))

    dbf = np.random.RandomState(2).rand(*vol.shape).astype(np.float32)
    n_max = 1 << max(int(np.ceil(np.log2(max(n_j, 2)))), 1)
    want = jccl.label_info(cc_j, jnp.asarray(vol), n_max=n_max,
                           rep_prefix=pre_j, dbf=jnp.asarray(dbf))
    got = tccl.label_info(cc_t, labels_t, n_max=n_max, rep_prefix=pre_t,
                          dbf=torch.from_numpy(dbf))
    names = ("counts", "bbox_min", "bbox_max", "orig", "dbfmax")
    for name, w, g in zip(names, want, got):
        g = g.numpy()
        if name == "orig":
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_connected_components_winding_component_uses_pointer_jumps():
    """A serpentine component needs more sweep rounds than the first
    phase allows; the pointer-jump phase must reach the same ids."""
    vol = np.zeros((24, 24, 3), dtype=np.int32)
    for i, x in enumerate(range(1, 23, 2)):
        vol[x, 1:23, 1] = 3
        y = 22 if i % 2 == 0 else 1
        vol[x:x + 3, y, 1] = 3
    raw_j = np.asarray(jccl.connected_components(jnp.asarray(vol)))
    raw_t = tccl.connected_components(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(raw_t, raw_j)
    assert len(np.unique(raw_t[raw_t > 0])) == 1


@pytest.mark.parametrize("black_border", (False, True))
@pytest.mark.parametrize("anisotropy", ((1.0, 1.0, 1.0), (16.0, 16.0, 40.0)))
def test_edt_matches_jax(anisotropy, black_border):
    rng = np.random.RandomState(5)
    vol = np.zeros((40, 34, 24), dtype=np.int32)
    vol[2:38, 3:30, 1:23] = 1
    vol[10:30, 5:32, 5:15] = 2
    vol[20:39, 20:33, 2:20] = 3   # thick: escalates the parabola band
    vol[rng.rand(*vol.shape) < 0.01] = 0
    want = np.asarray(jedt.edt(jnp.asarray(vol), anisotropy,
                               black_border=black_border))
    got = tedt.edt(torch.from_numpy(vol), anisotropy,
                   black_border=black_border).numpy()
    np.testing.assert_array_equal(got, want)


def test_edt_single_label_is_big_without_border():
    vol = np.ones((6, 5, 4), dtype=np.int32)
    got = tedt.edtsq(torch.from_numpy(vol), (1, 1, 1), black_border=False)
    want = np.asarray(jedt.edtsq(jnp.asarray(vol), (1, 1, 1),
                                 black_border=False))
    np.testing.assert_array_equal(got.numpy(), want)


def test_geodesic_fields_match_jax():
    """distance_field (euclid and node), parent_field and the invalidation
    ball of the host trace path, through kernel B5's plain version."""
    vol = _blobs(seed=3) == 2
    rng = np.random.RandomState(6)
    src = tuple(np.argwhere(vol)[0])
    ok_t = torch.from_numpy(vol)

    d_j = jgeo.euclidean_distance_field(vol, src, ANIS)
    d_t = tgeo.euclidean_distance_field(ok_t, src, ANIS)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))

    nc = np.where(vol, rng.rand(*vol.shape) * 4, np.inf).astype(np.float32)
    init = np.full(vol.shape, np.inf, dtype=np.float32)
    init[src] = 0.0
    n_j = jgeo.distance_field(vol, init, ANIS, node_cost=nc)
    n_t = tgeo.distance_field(ok_t, torch.from_numpy(init), ANIS,
                              node_cost=torch.from_numpy(nc))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))

    p_j = jgeo.parent_field(n_j, vol, ANIS, node_cost=nc)
    p_t = tgeo.parent_field(n_t, ok_t, ANIS, node_cost=torch.from_numpy(nc))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))

    dbf = np.where(vol, rng.rand(*vol.shape) * 30, 0).astype(np.float32)
    path = np.argwhere(vol)[::9][:6]
    b_j = jgeo.invalidation_ball(vol, dbf, path, 1.5, 20.0, ANIS)
    b_t = tgeo.invalidation_ball(ok_t, torch.from_numpy(dbf), path, 1.5, 20.0,
                                 ANIS)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def test_fill_matches_jax():
    n = 14
    g = np.indices((n, n, n)).transpose(1, 2, 3, 0)
    r2 = np.sum((g - n // 2) ** 2, axis=-1)
    shell = (r2 <= 36) & (r2 > 4)
    shell[n // 2, n // 2, :3] = True   # a tunnel stub does not open it
    f_j, n_j = jfill.fill(shell, return_fill_count=True)
    f_t, n_t = tfill.fill(torch.from_numpy(shell), return_fill_count=True)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert n_t == int(n_j) > 0

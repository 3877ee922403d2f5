"""The rail-field pointer chase of the port (the host `_chase` and the
lane-batched `chase_batched`) against the JAX package's
`fused_trace._chase` under jax.jit and jax.vmap: equal paths, lengths and
rail flags, including walks that leave the crop, where JAX's index rule
(a negative index counts from the end once, then clamps) decides what the
walk reads.

`data/chase_jax.npz` keeps lanes of walks and JAX's vmapped chase of them,
with and without a voxel graph, so that the CUDA kernel is held to JAX's
output on a machine without JAX (tests/test_torch_gpu.py). Written by

    JAX_PLATFORMS=cpu python tests/test_torch_chase.py

and checked here against a fresh JAX run."""

from pathlib import Path

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

FIXTURE = Path(__file__).resolve().parent / "data" / "chase_jax.npz"


def _fixture_lanes():
    """(padded rail fields, starts, uint32 voxel graph, L) of the fixture:
    the cases above and 28 random lanes of the same shape, a kind by lane
    index mod 4: 0, a Chebyshev distance to three rail voxels (many exact
    ties) with +inf holes and +inf padding; 1, all +inf; 2, small positive
    integers, no rail; 3, kind 0 with finite padding, started up to 3
    voxels outside the crop. The graph has about three bits in four set.
    L is 2 * sum(crop), as the crop engine gives it."""
    rng = np.random.RandomState(11)
    P = tuple(n + 2 for n in SHAPE)
    idx = np.indices(P).transpose(1, 2, 3, 0)
    fields = [c[1] for c in CASES]
    starts = [c[2] for c in CASES]
    for b in range(28):
        kind = b % 4
        if kind in (0, 3):
            rails = rng.randint(1, np.array(SHAPE) + 1, size=(3, 3))
            f = np.abs(idx[None] - rails[:, None, None, None]).max(-1).min(0)
            f = np.where(rng.rand(*P) < 0.1, np.inf, f).astype(np.float32)
            if kind == 0:
                f[0], f[-1] = np.inf, np.inf
                f[:, 0], f[:, -1] = np.inf, np.inf
                f[..., 0], f[..., -1] = np.inf, np.inf
        elif kind == 1:
            f = np.full(P, np.inf, np.float32)
        else:
            f = rng.randint(1, 4, size=P).astype(np.float32)
        fields.append(f)
        lo, hi = (-3, np.array(SHAPE) + 3) if kind == 3 else (0, SHAPE)
        starts.append(tuple(rng.randint(lo, hi)))
    vg = (rng.randint(0, 2**32, size=(len(fields),) + P, dtype=np.uint64)
          | rng.randint(0, 2**32, size=(len(fields),) + P, dtype=np.uint64))
    return (np.stack(fields), np.array(starts, dtype=np.int64),
            vg.astype(np.uint32), 2 * sum(SHAPE))


def _jax_batched(d_pad, starts, max_len, vg=None):
    """JAX's chase vmapped over lanes: (path, length, reached) as numpy."""
    if vg is None:
        fn = jax.vmap(lambda dp, st: fused_trace._chase(dp, st, max_len))
        out = fn(jnp.asarray(d_pad), jnp.asarray(starts, dtype=jnp.int32))
    else:
        fn = jax.vmap(lambda dp, st, g: fused_trace._chase(dp, st, max_len,
                                                           g))
        out = fn(jnp.asarray(d_pad), jnp.asarray(starts, dtype=jnp.int32),
                 jnp.asarray(vg))
    return tuple(np.asarray(a) for a in out)


def _write_fixture():
    d_pad, starts, vg, max_len = _fixture_lanes()
    out = {"d_pad": d_pad, "start": starts, "vg": vg,
           "max_len": np.int64(max_len)}
    for tag, g in (("plain", None), ("vg", vg)):
        p, n, r = _jax_batched(d_pad, starts, max_len, g)
        out.update({f"path_{tag}": p, f"length_{tag}": n,
                    f"reached_{tag}": r})
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **out)


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


def test_jax_fixture_is_jax_output():
    """The stored lanes are the ones `_fixture_lanes` makes, and the stored
    walks are JAX's on them; the kinds each occur (rails reached, walks
    run to the buffer's end, graph-closed steps)."""
    with np.load(FIXTURE) as f:
        fx = dict(f)
    d_pad, starts, vg, max_len = _fixture_lanes()
    for k, v in (("d_pad", d_pad), ("start", starts), ("vg", vg)):
        np.testing.assert_array_equal(fx[k], v)
    assert int(fx["max_len"]) == max_len
    for tag, g in (("plain", None), ("vg", vg)):
        for k, a in zip(("path", "length", "reached"),
                        _jax_batched(d_pad, starts, max_len, g)):
            np.testing.assert_array_equal(fx[f"{k}_{tag}"], a)
        assert fx[f"reached_{tag}"].any()
        assert (fx[f"length_{tag}"] == max_len).any()
    assert not np.array_equal(fx["path_plain"], fx["path_vg"])


@pytest.mark.parametrize("graph", (None, "uint32", "int32"))
def test_batched_chase_matches_jax_fixture(graph):
    """The CPU route of chase_batched equals the stored JAX walks."""
    with np.load(FIXTURE) as f:
        fx = dict(f)
    vg = None if graph is None else torch.from_numpy(
        fx["vg"] if graph == "uint32" else fx["vg"].view(np.int32))
    tag = "plain" if graph is None else "vg"
    got = chase_batched(torch.from_numpy(fx["d_pad"]),
                        torch.from_numpy(fx["start"]), int(fx["max_len"]), vg)
    for k, a in zip(("path", "length", "reached"), got):
        np.testing.assert_array_equal(a.numpy(), fx[f"{k}_{tag}"])


def test_walks_leave_the_crop():
    """The fixture exercises the wrap rule: two walks step outside the
    crop, one of them over finite values only."""
    for name in ("leaves_through_finite", "rail_through_wrap"):
        _, d_pad, start = CASES[[c[0] for c in CASES].index(name)]
        wp, wl, _ = _jax_chase(d_pad, start)
        assert (wp[:wl] < 0).any(), name
        if name == "leaves_through_finite":
            assert np.isfinite(d_pad).all()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """chase_batched on CPU tensors runs the plain version, with and
    without a graph, and launches no kernel."""
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops import chase

    calls = []
    plain = chase._chase_batched_plain

    def spy(*args):
        calls.append(args[3] is not None)
        return plain(*args)

    monkeypatch.setattr(chase, "_chase_batched_plain", spy)
    d_pad = torch.from_numpy(np.stack([c[1] for c in CASES]))
    starts = torch.from_numpy(np.array([c[2] for c in CASES]))
    vg = torch.from_numpy(np.random.RandomState(5).randint(
        0, 2**31 - 1, size=d_pad.shape).astype(np.int32))
    before = dict(kernels.LAUNCHES)
    for g in (None, vg):
        got = chase.chase_batched(d_pad, starts, L, g)
        for a, b in zip(got, plain(d_pad, starts, L, g)):
            assert torch.equal(a, b)
    assert calls == [False, True]
    assert kernels.LAUNCHES == before


if __name__ == "__main__":
    _write_fixture()

"""The port's host stages (`fill_holes`, `fix_avocados`) against the JAX
package: `ops.fill.fill` (3-D and 2-D), the lane-batched flood, the
batched hole masks `fill_label_crops`, `fill_all_holes`, the avocado
passes, the global engine's own first voxels, and one whole-volume
`skeletonize(fill_holes=True, fix_avocados=True)` on the CPU. Masks,
counts, labels and remappings must be equal, skeletons equal in
vertices, edges and radii."""

import numpy as np
import pytest
import scipy.ndimage

import jax
import jax.numpy as jnp
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu import intake as jintake
from kimimaro_tpu.ops import edt as jedt
from kimimaro_tpu.ops import fill as jfill
from kimimaro_tpu.ops import geodesic as jgeodesic
from kimimaro_tpu_torch import gengine as tgengine
from kimimaro_tpu_torch import intake as tintake
from kimimaro_tpu_torch.ops import edt as tedt
from kimimaro_tpu_torch.ops import fill as tfill
from kimimaro_tpu_torch.ops import geodesic as tgeodesic
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _fill_input(case):
    if case == "hole":
        b = np.ones((10, 10, 10), dtype=bool)
        b[4:6, 4:6, 4:6] = False
    elif case == "notch":
        b = np.ones((10, 10, 10), dtype=bool)
        b[0:5, 4:6, 4:6] = False  # open to the border
    elif case == "random":
        b = np.random.default_rng(5).random((16, 16, 16)) > 0.35
    elif case == "2d":
        b = np.ones((8, 8), dtype=bool)
        b[3:5, 3:5] = False
    else:  # 2-D, random, holes touching nothing but the perimeter rule
        b = np.random.default_rng(6).random((13, 11)) > 0.4
    return b


@pytest.mark.parametrize("case", ("hole", "notch", "random", "2d",
                                  "2d_random"))
def test_fill_matches_jax(case):
    b = _fill_input(case)
    want, want_n = jfill.fill(b, return_fill_count=True)
    got, got_n = tfill.fill(torch.from_numpy(b), return_fill_count=True)
    assert got.shape == b.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_n == int(want_n)
    np.testing.assert_array_equal(got.numpy(),
                                  scipy.ndimage.binary_fill_holes(b))


@pytest.mark.parametrize("rounds", (0, 1, 3))
def test_flood6_stage_lanes_match_jax(rounds):
    """Each lane of the port's lane-batched flood equals the JAX flood's
    reachability and stall flag at the same (few) rounds."""
    rng = np.random.default_rng(3)
    ok = rng.random((4, 12, 10, 9)) > 0.3
    seed = np.zeros_like(ok)
    seed[:, 0] = True
    seed[1] = False  # a lane with no seed converges at once
    got, conv = tgeodesic._flood6_stage(torch.from_numpy(ok),
                                        torch.from_numpy(seed), rounds)
    for lane in range(ok.shape[0]):
        init = jnp.where(jnp.asarray(seed[lane] & ok[lane]), 0.0, jnp.inf)
        d, c = jgeodesic._flood6_stage(jnp.asarray(ok[lane]), init, rounds)
        np.testing.assert_array_equal(got[lane].numpy(),
                                      np.isfinite(np.asarray(d)))
        assert bool(conv[lane]) == bool(c), lane


def _crop_fixture(case):
    if case == "boxes":
        vol = np.zeros((24, 20, 18), dtype=np.uint32)
        vol[2:12, 2:12, 2:12] = 1
        vol[5:8, 5:8, 5:8] = 0
        vol[14:22, 3:17, 3:15] = 2
        vol[16:20, 6:14, 6:12] = 0
        vol[17:19, 8:12, 8:10] = 3  # label inside label 2's hole
        vol[1:4, 14:19, 12:17] = 4  # solid, nothing to fill
        return vol
    # tiers 16 to 128 in one 130 x 40 x 36 volume: shells with holes
    vol = np.zeros((130, 40, 36), dtype=np.uint32)
    lid = 1
    for x0, ext in ((1, 6), (10, 14), (26, 30), (1, 129)):
        ex = (ext, min(ext, 38), min(ext, 34))
        y0, z0 = (20, 1) if ext == 129 else (1, 1)
        sl = tuple(slice(a, a + e) for a, e in zip((x0, y0, z0), ex))
        if ext == 129:
            sl = (slice(1, 130), slice(20, 39), slice(1, 35))
        vol[sl] = lid
        inner = tuple(slice(s.start + 2, s.stop - 2) for s in sl)
        vol[inner] = 0
        lid += 1
    return vol


@pytest.mark.parametrize("case", ("boxes", "tiers"))
def test_fill_label_crops_matches_jax(case):
    vol = _crop_fixture(case)
    slcs = scipy.ndimage.find_objects(vol)
    lids = [i + 1 for i, s in enumerate(slcs) if s is not None]
    offs = np.array([[x.start for x in slcs[i - 1]] for i in lids])
    shapes = np.array([[x.stop - x.start for x in slcs[i - 1]]
                       for i in lids])
    want = jfill.fill_label_crops(jnp.asarray(vol), offs, shapes,
                                  np.array(lids), vol.shape)
    got = tfill.fill_label_crops(torch.from_numpy(vol.astype(np.int32)),
                                 offs, shapes, np.array(lids), vol.shape)
    assert sum(n for _, n in got) > 0
    for (gh, gn), (wh, wn) in zip(got, want):
        assert gn == wn
        if wn == 0:
            assert gh is None
        else:
            np.testing.assert_array_equal(gh, wh)


def _serial_fill_all_holes(cc_labels):
    """kimimaro's serial per-label loop (tests/test_ops_fill.py's oracle)."""
    cc_labels = np.copy(cc_labels)
    labels = np.unique(cc_labels)
    labels_set = set(int(u) for u in labels if u != 0)
    all_slices = scipy.ndimage.find_objects(cc_labels)
    filled_px = 0
    for label in labels:
        label = int(label)
        if label not in labels_set or all_slices[label - 1] is None:
            continue
        slices = all_slices[label - 1]
        binimg = cc_labels[slices] == label
        filled = scipy.ndimage.binary_fill_holes(binimg)
        n = int(filled.sum() - binimg.sum())
        filled_px += n
        if n == 0:
            continue
        sub = set(int(u) for u in np.unique(cc_labels[slices][filled]))
        sub.discard(label)
        labels_set -= sub
        cc_labels[slices] = np.where(filled, label, cc_labels[slices])
    return cc_labels, filled_px


def _nested_boxes(trial):
    rng = np.random.RandomState(7)
    for _ in range(trial + 1):
        vol = np.zeros((28, 26, 24), dtype=np.uint32)
        for lid in range(1, 9):
            c = rng.randint(2, 20, size=3)
            e = rng.randint(3, 9, size=3)
            vol[c[0]:c[0] + e[0], c[1]:c[1] + e[1], c[2]:c[2] + e[2]] = lid
    return vol


def _noisy_halves():
    labels = np.zeros((64, 32, 32), dtype=np.uint32)
    labels[0:32] = 1
    labels[32:64] = 8
    rng = np.random.RandomState(42)
    labels[1:31, 1:31, 1:31] = rng.randint(1, 8, size=(30, 30, 30))
    labels[33:63, 1:31, 1:31] = rng.randint(8, 11, size=(30, 30, 30))
    return labels


@pytest.mark.parametrize("case", ("boxes0", "boxes1", "boxes2", "halves"))
def test_fill_all_holes_matches_jax(case):
    vol = _noisy_halves() if case == "halves" else _nested_boxes(
        int(case[-1]))
    want, want_n = jintake.fill_all_holes(vol, return_fill_count=True)
    got, got_n = tintake.fill_all_holes(vol, return_fill_count=True,
                                        device="cpu")
    assert got_n == want_n
    np.testing.assert_array_equal(got, np.asarray(want))
    oracle, oracle_n = _serial_fill_all_holes(vol)
    assert got_n == oracle_n
    np.testing.assert_array_equal(got, oracle)
    if case == "halves":
        assert set(np.unique(got)) == {1, 8}


def _avocado_labels():
    labels = np.zeros((32, 32, 32), dtype=np.uint32)
    labels[:13, :10, :8] = 1  # fake clipped avocado
    labels[:6, :5, :6] = 2
    labels[13:25, 10:25, 8:20] = 3  # double avocado
    labels[15:23, 13:23, 10:18] = 4
    labels[15:18, 13:22, 11:17] = 5
    labels[28:, 28:, 28:] = 6  # not a pit
    labels[25:28, 28:, 28:] = 7  # not a fruit
    return labels


def test_avocado_protection_matches_jax():
    labels = _avocado_labels()

    def jfn(lbls):
        return np.asarray(jax.device_get(jedt.edt(lbls, (1, 1, 1))))

    def tfn(lbls):
        return tedt.edt(torch.from_numpy(lbls.astype(np.int32)),
                        (1.0, 1.0, 1.0)).numpy()

    remap = {i: i + 100 for i in range(1, 8)}
    want = jintake.engage_avocado_protection(
        labels, jfn(labels), remap, soma_detection_threshold=1, edtfn=jfn)
    got = tintake.engage_avocado_protection(
        labels, tfn(labels), remap, soma_detection_threshold=1, edtfn=tfn,
        device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]
    assert set(np.unique(got[0]).tolist()) == {0, 1, 2, 3, 4}
    assert np.all(got[0][13:25, 10:25, 8:20] == 2)


@pytest.mark.parametrize("seed", (0, 1))
def test_avocado_pieces_match_jax(seed):
    """find_avocado_fruit from random points and _paint_walls of random
    masks, both equal to the JAX package's."""
    labels = _avocado_labels()
    rng = np.random.RandomState(seed)
    for p in rng.randint(0, 32, size=(40, 3)):
        assert (tintake.find_avocado_fruit(labels, *p)
                == jintake.find_avocado_fruit(labels, *p))
    b = rng.rand(9, 8, 7) > 0.3
    want = jintake._paint_walls(b.copy())
    got = tintake._paint_walls(b.copy(), torch.device("cpu"))
    np.testing.assert_array_equal(got, want)


def test_first_voxels_match_jax():
    from kimimaro_tpu import gengine as jgengine

    rng = np.random.RandomState(2)
    cc = rng.randint(0, 9, size=(11, 9, 7)).astype(np.int32)
    cc[cc == 5] = 0  # an absent id
    want = np.asarray(jgengine._first_voxels(jnp.asarray(cc), 16))
    got = tgengine._first_voxels(torch.from_numpy(cc), 16).numpy()
    np.testing.assert_array_equal(got, want)


def _hollow_blobs():
    """The blob fixture of tests/test_torch_skeletonize.py with a hole
    carved into one label and a pit label nested in another."""
    rng = np.random.RandomState(1)
    shape = (40, 36, 30)
    vol = np.zeros(shape, dtype=np.uint32)
    for lab in range(1, 7):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        m = (e + rng.rand(*shape) * 0.4) < 1.0
        vol[m & (vol == 0)] = lab
    x, y, z = np.ogrid[:40, :36, :30]
    # a ball with a carved hole (fill_holes), clipped by the x = 0 face,
    # with a pit label on that face (an avocado: fill_holes leaves it)
    r2 = (x - 3) ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2
    vol[r2 <= 100] = 8
    vol[((x - 6) ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2) <= 6] = 0
    vol[((x - 0) ** 2 + (y - 18) ** 2 + ((z - 15) * 1.2) ** 2) <= 12] = 9
    return vol


def test_skeletonize_host_stages_match_jax():
    vol = _hollow_blobs()
    tp = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 60,
          "soma_acceptance_threshold": 3500}
    kw = dict(teasar_params=tp, anisotropy=(16, 16, 40), dust_threshold=10,
              fix_borders=True, fill_holes=True, fix_avocados=True)
    want = kimimaro_tpu.skeletonize(vol.copy(), **kw)
    before = vol.copy()
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.skeletonize(vol, device="cpu", **kw)
    finally:
        profiling.collect(False)
    np.testing.assert_array_equal(vol, before)  # the caller's array
    stats = profiling.get_stats()
    assert stats["counters"]["fill_labels"] >= 1
    assert stats["counters"]["avocado_passes"] >= 1
    assert stats["counters"].get("gengine_iterations", 0) == 0
    assert stats["counters"]["crop_engine_jobs"] >= len(want)
    assert 9 not in got and 8 in got  # the pit joined its fruit
    assert set(got) == set(want)
    for k in want:
        assert kimimaro_tpu.Skeleton.equivalent(got[k], want[k]), k
        np.testing.assert_array_equal(
            np.sort(got[k].radii), np.sort(want[k].radii))


def test_trace_global_finds_its_first_voxels(monkeypatch):
    """The global engine given no first voxels (the host-stage branch's
    call) finds them itself: the same skeletons as with intake's."""
    tp = {"scale": 1.5, "const": 30, "pdrf_exponent": 4,
          "pdrf_scale": 100000, "soma_detection_threshold": 1e9,
          "soma_acceptance_threshold": 1e9}
    vol = _hollow_blobs()
    kw = dict(teasar_params=tp, anisotropy=(16, 16, 40), dust_threshold=10,
              device="cpu")
    want = kimimaro_tpu_torch.skeletonize(vol, **kw)
    inner = tgengine.trace_global

    def without(*a, firstvox_arr=None, **k):
        return inner(*a, firstvox_arr=None, **k)

    monkeypatch.setattr(tgengine, "trace_global", without)
    profiling.reset_stats()
    profiling.collect(True)
    try:
        got = kimimaro_tpu_torch.skeletonize(vol, **kw)
    finally:
        profiling.collect(False)
    assert profiling.get_stats()["counters"]["gengine_jobs"] >= 2
    assert set(got) == set(want)
    for k in want:
        assert kimimaro_tpu.Skeleton.equivalent(got[k], want[k]), k

"""kimimaro_tpu_torch.CompressedLabelVolume against the JAX package's
(the fixtures of tests/test_carray.py), and the port's streaming intake:
skeletonize of a CompressedLabelVolume equals skeletonize of the plain
array and the JAX package's, and never materializes the whole volume;
the streamed device volume equals the plain upload, with a partial last
slab, a wide dtype and object_ids."""

import numpy as np
import pytest
import torch

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu.carray import CompressedLabelVolume as JCLV
from kimimaro_tpu_torch import intake as tintake
from kimimaro_tpu_torch.carray import CompressedLabelVolume as TCLV

torch.set_num_threads(1)


def make_volume():
    labels = np.zeros((24, 20, 37), dtype=np.uint32)  # odd z: partial slab
    labels[2:12, 3:9, 4:30] = 5
    labels[14:22, 10:18, 8:20] = 9
    labels[0:4, 14:19, 31:36] = 70000
    return labels


def test_roundtrip_slicing_and_metadata_match_jax():
    labels = make_volume()
    tv, jv = TCLV(labels, slab=8), JCLV(labels, slab=8)
    assert tv.nbytes_compressed == jv.nbytes_compressed
    np.testing.assert_array_equal(tv.to_numpy(), labels)
    np.testing.assert_array_equal(np.asarray(tv), labels)
    for key in ((slice(3, 9), slice(4, 7), slice(11, 29)),
                (slice(None), slice(None), 36), 5,
                (slice(None), slice(None), slice(30, 5, -2))):
        np.testing.assert_array_equal(tv[key], jv[key])
    assert tv.voxel_counts() == jv.voxel_counts()
    tb, jb = tv.bounding_boxes(), jv.bounding_boxes()
    assert set(tb) == set(jb)
    for k in tb:
        np.testing.assert_array_equal(tb[k][0], jb[k][0])
        np.testing.assert_array_equal(tb[k][1], jb[k][1])
    np.testing.assert_array_equal(tv.unique(), jv.unique())
    for lab in (5, 70000, 4):
        (tm, ts), (jm, js) = tv.decompress(lab), jv.decompress(lab)
        np.testing.assert_array_equal(tm, jm)
        assert ts == js
    np.testing.assert_array_equal(
        tv.remap({5: 1, 9: 2}).to_numpy(), jv.remap({5: 1, 9: 2}).to_numpy())
    np.testing.assert_array_equal(
        tv.remap({5: 1}, preserve_missing_labels=False).to_numpy(),
        jv.remap({5: 1}, preserve_missing_labels=False).to_numpy())


def _poison(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("streaming path materialized the full volume")

    monkeypatch.setattr(TCLV, "to_numpy", boom)
    monkeypatch.setattr(TCLV, "__array__", boom)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert kimimaro_tpu.Skeleton.equivalent(a[k], b[k]), k


@pytest.mark.parametrize("case", ("plain", "wide_object_ids"))
def test_skeletonize_streams_without_materializing(case, monkeypatch):
    dtype = np.uint32 if case == "plain" else np.uint64
    hi = 0 if case == "plain" else 2**40
    labels = np.zeros((40, 24, 21), dtype=dtype)  # 21: a partial slab
    labels[4:36, 8:16, 8:16] = hi + 7
    labels[10:30, 2:6, 2:6] = hi + 11
    kw = dict(anisotropy=(1, 1, 1), dust_threshold=10)
    if case != "plain":
        kw["object_ids"] = [hi + 7]
    plain = kimimaro_tpu_torch.skeletonize(labels, device="cpu", **kw)
    cv = TCLV(labels, slab=8)
    _poison(monkeypatch)
    got = kimimaro_tpu_torch.skeletonize(cv, device="cpu", **kw)
    assert set(got) == ({7, 11} if case == "plain" else {hi + 7})
    _same(got, plain)
    if case == "plain":  # the plain array's path is held to JAX elsewhere
        _same(got, kimimaro_tpu.skeletonize(labels, **kw))


@pytest.mark.parametrize("case", ("uint32_narrow", "uint32_wide_values",
                                  "int16_negative", "uint64_object_ids",
                                  "bool"))
def test_streamed_volume_equals_plain_upload(case):
    rng = np.random.RandomState(1)
    shape = (9, 7, 13)  # 13 with slabs of 4: a partial last slab
    if case == "uint32_narrow":
        labels = rng.randint(0, 5, size=shape).astype(np.uint32)
    elif case == "uint32_wide_values":
        labels = rng.randint(0, 5, size=shape).astype(np.uint32) * 2**30
    elif case == "int16_negative":
        labels = rng.randint(-3, 4, size=shape).astype(np.int16)
    elif case == "uint64_object_ids":
        labels = (rng.randint(0, 5, size=shape).astype(np.uint64)
                  * np.uint64(2**40))
    else:
        labels = rng.rand(*shape) > 0.5
    obj = [2**40, 3 * 2**40] if case == "uint64_object_ids" else None
    mn, mx, wide_back, up = tintake._plan_streaming(TCLV(labels, slab=4),
                                                    obj)
    got = up(torch.device("cpu"))
    host = tintake.apply_object_mask(labels, obj)
    assert (mn, mx) == (int(host.min()), int(host.max()))
    if wide_back is not None:
        u = np.unique(host)
        u = u[u != 0]
        assert wide_back == {i + 1: int(v) for i, v in enumerate(u)}
        host = (np.searchsorted(u, host).astype(np.uint32) + 1) * (host != 0)
    want = tintake._upload(host, torch.device("cpu"))
    assert got.dtype == torch.int32
    assert torch.equal(got, want)

"""kimimaro_tpu_torch.chunked against the JAX package's chunked protocol
(tests/test_chunked.py): equal chunk bounds, chunked skeletons equal to
the JAX package's, one component across the seams, and the seam merge."""

import numpy as np
import pytest
import torch

from kimimaro_tpu import chunked as jchunked
from kimimaro_tpu.skeleton import Skeleton as JSkeleton
from kimimaro_tpu_torch import chunked as tchunked
from kimimaro_tpu_torch.skeleton import Skeleton as TSkeleton

torch.set_num_threads(1)

PARAMS = {"const": 10, "scale": 10, "pdrf_exponent": 4, "pdrf_scale": 100000}


@pytest.mark.parametrize("shape, chunk", (
    ((64, 64, 20), (32, 32, 10)), ((65, 7, 1), (32, 8, 4)),
    ((512, 512, 512), (256, 256, 256)), ((10, 10, 10), (100, 100, 100))))
def test_chunk_bounds_match_jax(shape, chunk):
    got = tchunked.chunk_bounds(shape, chunk)
    assert got == jchunked.chunk_bounds(shape, chunk)
    if shape == (64, 64, 20):
        assert len(got) == 8 and got[0][1] == (33, 33, 11)


def _tubes():
    """Two tubes across the x seam of two chunks of equal shape."""
    labels = np.zeros((41, 24, 12), dtype=np.uint8)
    labels[8:32, 10:14, :] = 1
    labels[2:38, 2:5, 2:6] = 2
    return labels


def test_skeletonize_chunked_matches_jax():
    labels = _tubes()
    kw = dict(chunk_size=(20, 24, 12), teasar_params=PARAMS,
              anisotropy=(1, 1, 1),
              dust_threshold=0, fix_borders=True,
              postprocess_params={"dust_threshold": 0, "tick_threshold": 1})
    want = jchunked.skeletonize_chunked(labels, **kw)
    got = tchunked.skeletonize_chunked(labels, device="cpu", **kw)
    assert set(got) == set(want) == {1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k].vertices, want[k].vertices)
        np.testing.assert_array_equal(got[k].edges, want[k].edges)
        assert got[k].to_swc() == want[k].to_swc()
        assert len(got[k].components()) == 1


def test_merge_chunk_skeletons_matches_jax():
    parts = []
    for cls in (JSkeleton, TSkeleton):
        a = cls([(0, 0, 0), (1, 0, 0)], [(0, 1)], radii=[1, 1], segid=5)
        b = cls([(1, 0, 0), (2, 0, 0)], [(0, 1)], radii=[1, 1], segid=5)
        c = cls([(9, 0, 0), (9, 1, 0)], [(0, 1)], radii=[2, 2], segid=6)
        parts.append([{5: a, 6: c}, {5: b}])
    want = jchunked.merge_chunk_skeletons(parts[0], dust_threshold=0.5)
    got = tchunked.merge_chunk_skeletons(parts[1], dust_threshold=0.5)
    assert set(got) == set(want) == {5, 6}
    for k in want:
        assert got[k].to_swc() == want[k].to_swc()
    assert len(got[5].components()) == 1 and got[5].vertices.shape[0] == 3

"""The traffic generator: deterministic in its seeds, ties to the lower seed
index, and chunks that are relabellings of the base volume."""

import numpy as np
import pytest
import torch

import gen

from steps import merge, voronoi

SHAPE = [48, 48, 48]
VORONOI = {"step": "voronoi", "labels": 40, "scale": [16, 16, 40], "seed": 11}
NEURITE = {"step": "neurite", "tubes": 6, "seed": 11, "scale": [16, 16, 40],
           "length": [20, 60], "turn": 0.18, "radius": [1.8, 4.0],
           "branches": [0, 3], "branch_length": [10, 30], "soma_share": 0.5,
           "soma_radius": [5, 8]}
TRAFFIC = {
    "dense": [VORONOI],
    "soma": [VORONOI, {"step": "hollow", "seed": 4, "labels": 20, "pits": 3,
                       "balls": 2, "ball_radius": 8, "ball_z_squash": 2.5}],
    "autapse": [VORONOI, {"step": "merge", "share": 4}],
    "neurite": [NEURITE],
}


def _bytes(kind, seed=None):
    steps = [dict(s) for s in TRAFFIC[kind]]
    if seed is not None:
        steps[0]["seed"] = seed
    vol, graph = gen.base_volume({"chunk": SHAPE}, {"steps": steps}, "cpu")
    return vol.numpy().tobytes() + (b"" if graph is None else
                                    graph.tobytes())


@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_same_seed_same_bytes(kind):
    assert _bytes(kind) == _bytes(kind)
    assert _bytes(kind) != _bytes(kind, seed=12)


def test_voronoi_is_the_nearest_seed_with_ties_to_the_lower_index():
    vol = voronoi.voronoi([20, 20, 8], 30, [16, 16, 40], 5, "cpu").numpy()
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    pts = torch.stack([torch.randint(0, s, (30,), generator=g)
                       for s in (20, 20, 8)], dim=1).numpy()
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in (20, 20, 8)],
                                indexing="ij"), -1).reshape(-1, 3)
    w = np.array([16, 16, 40], np.int64)
    d = (((grid[:, None, :] - pts[None]) * w) ** 2).sum(-1)
    # np.argmin takes the first of equal minima: the lower index
    assert (vol.reshape(-1) == d.argmin(axis=1) + 1).all()


def test_merge_graph_is_the_connectivity_of_the_labels_before():
    pre = voronoi.voronoi([16, 16, 8], 10, [16, 16, 40], 2, "cpu")
    merged, graph = merge.merge(pre, {"share": 4})
    p = pre.numpy()
    for o, bit in gen.GRAPH_BITS.items():
        a, b = gen.pair_slices(o, p.shape)
        want = p[a] == p[b]
        assert (((graph[a] >> bit) & 1).astype(bool) == want).all()
    # merges only join touching labels; the merged volume has fewer ids
    assert len(np.unique(merged.numpy())) < len(np.unique(p))


def test_chunks_relabel_the_base_volume_from_the_seed():
    base, _ = gen.base_volume({"chunk": [16, 16, 16]}, {"steps": [
        VORONOI, {"step": "hollow", "seed": 4, "labels": 4, "pits": 1,
                  "balls": 1, "ball_radius": 3, "ball_z_squash": 2.5}]},
        "cpu")
    one, two = gen.Chunks(base, 2 ** 40 + 3), gen.Chunks(base, 2 ** 40 + 3)
    for _ in range(2):
        (c1, l1), (c2, l2) = one.next(), two.next()
        assert (c1 == c2).all() and (l1 == l2).all()
        assert (c1.astype(np.int64) == l1[base.numpy()]).all()
        assert l1[0] == 0 and sorted(l1) == list(range(len(l1)))


def test_neurite_tubes_keep_the_lowest_label_where_they_cross():
    from steps import neurite

    v = gen.base_volume({"chunk": SHAPE}, {"steps": [dict(NEURITE,
                        tubes=40)]}, "cpu")[0].numpy()
    assert v.dtype == np.int32 and 0 < (v > 0).mean() < 0.5
    assert len(np.unique(v)) > 20
    # first writer wins whatever the order of stamping: a voxel keeps the
    # lowest label of the balls over it
    big = torch.iinfo(torch.int32).max
    vol = torch.full((12, 12, 12), big, dtype=torch.int32)
    c = torch.tensor([[5.0, 5.0, 5.0], [7.0, 5.0, 5.0]])
    neurite._stamp(vol, c[1:], torch.tensor([2]), 3, 1.0)
    neurite._stamp(vol, c[:1], torch.tensor([1]), 3, 1.0)
    assert vol[5, 5, 5] == 1 and vol[7, 5, 5] == 1 and vol[10, 5, 5] == 2
    assert vol[0, 0, 0] == big

"""kimimaro_tpu_torch.post (postprocess, join_close_components, the dust,
loop and tick removals, find_cycle, create_distance_graph and the row
helpers) and extract_skeleton_from_binary_image against the JAX package,
on the fixtures of tests/test_post.py and on random skeletons with loops,
ticks and dust. Every case runs on the port's native route (the g++
library of kimimaro_tpu_torch.native) and on its pure-python route; SWC
text, vertices and edges must be equal, distance-graph weights within
rtol 1e-6."""

import numpy as np
import pytest

import kimimaro_tpu
import kimimaro_tpu_torch
from kimimaro_tpu import post as jpost
from kimimaro_tpu.skeleton import Skeleton as JSkeleton
from kimimaro_tpu_torch import native
from kimimaro_tpu_torch import post as tpost
from kimimaro_tpu_torch.skeleton import Skeleton as TSkeleton

ROUTES = ("native", "python")


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's route for the test body: the native library (required to
    build) or the pure-python fallback (the loader made to find none)."""
    if request.param == "native":
        assert native.available(), "the native library did not build"
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert not native.available()
    return request.param


def _pair(*args, **kw):
    return JSkeleton(*args, **kw), TSkeleton(*args, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.radii, want.radii)
    assert got.to_swc() == want.to_swc()


CYCLE_EDGES = (
    [[0, 1], [1, 2], [2, 0], [2, 3], [2, 4]],
    [[0, 1], [1, 2], [2, 3], [3, 4], [4, 10], [10, 11], [11, 12], [12, 2],
     [4, 5], [5, 6], [6, 7]],
    [[0, 1], [0, 20], [20, 21], [21, 22], [22, 23], [23, 21], [1, 2],
     [2, 3], [3, 4], [4, 5], [5, 6], [6, 7], [7, 10], [10, 11], [11, 6]],
    [[0, 1], [1, 2]],
)


@pytest.mark.parametrize("case", range(len(CYCLE_EDGES)))
def test_find_cycle_matches_jax(case, route):
    edges = np.array(CYCLE_EDGES[case], dtype=np.int32)
    got = tpost.find_cycle(edges)
    want = jpost.find_cycle(edges)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _join_cases():
    yield "simple", dict(
        vertices=[(0, 0, 0), (1, 0, 0), (10, 0, 0), (11, 0, 0)],
        edges=[(0, 1), (2, 3)], radii=[0, 1, 2, 3],
        vertex_types=[0, 1, 2, 3], segid=1337), (
        dict(radius=np.inf), dict(radius=9), dict(radius=8.5))
    yield "complex", dict(
        vertices=[(0, 0, 0), (1, 0, 0), (4, 0, 0), (6, 0, 0), (20, 0, 0),
                  (21, 0, 0), (0, 0, 5), (0, 0, 10)],
        edges=[(0, 1), (2, 3), (4, 5), (6, 7)]), (dict(radius=np.inf),)
    for radii in ([100] * 4, [1] * 4, [1, 0.9, 3, 1], [1, 1, 3, 1]):
        yield f"by_radius{radii}", dict(
            vertices=[(0, 0, 0), (1, 0, 0), (5, 0, 0), (11, 0, 0)],
            edges=[(0, 1), (2, 3)], radii=radii, vertex_types=[0, 1, 2, 3],
            segid=1337), (dict(restrict_by_radius=False),
                          dict(restrict_by_radius=True))


JOIN_CASES = list(_join_cases())


@pytest.mark.parametrize("case", range(len(JOIN_CASES)))
def test_join_close_components_matches_jax(case, route):
    _, kw, calls = JOIN_CASES[case]
    for call in calls:
        js, ts = _pair(**kw)
        want = kimimaro_tpu.join_close_components(js, **call)
        got = kimimaro_tpu_torch.join_close_components(ts, **call)
        _assert_same(got, want)
        assert len(got.components()) == len(want.components())


def _pieces(seed, n_pieces=12):
    """tests/test_post.py's random fragments for the sparse join."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_pieces):
        n = rng.randint(3, 9)
        base = rng.rand(3) * 50
        verts = (base + np.cumsum(rng.rand(n, 3) * 1.5, axis=0)).astype(
            np.float32)
        edges = np.stack([np.arange(n - 1), np.arange(1, n)],
                         axis=1).astype(np.uint32)
        out.append(dict(vertices=verts, edges=edges,
                        radii=rng.rand(n).astype(np.float32) + 0.2))
    return out


@pytest.mark.parametrize("radius", (np.inf, 1e6, 3.0))
def test_join_close_components_sparse_matches_jax(radius, route):
    pieces = _pieces(5)
    jm = JSkeleton.simple_merge([JSkeleton(**p) for p in pieces])
    tm = TSkeleton.simple_merge([TSkeleton(**p) for p in pieces])
    want = jpost.join_close_components(jm, radius=radius)
    got = tpost.join_close_components(tm, radius=radius)
    _assert_same(got, want)


def _random_skeleton(seed, n=160, loops=True):
    """A random tree of short steps (distinct vertices) with extra edges
    (loops), spurs (ticks) and a detached fragment (dust)."""
    rng = np.random.RandomState(seed)
    verts = np.zeros((n, 3), dtype=np.float32)
    edges = []
    for i in range(1, n):
        p = rng.randint(max(0, i - 6), i)
        verts[i] = verts[p] + rng.randint(-1, 2, size=3) * [4, 4, 10]
        edges.append((p, i))
    verts[:, 1] += np.arange(n, dtype=np.float32) * 0.01
    for _ in range(6 if loops else 0):
        a, b = rng.randint(0, n, size=2)
        if a != b:
            edges.append((min(a, b), max(a, b)))
    frag = (verts[:12] + 400).astype(np.float32)  # dust
    verts = np.concatenate([verts, frag])
    edges += [(n + i, n + i + 1) for i in range(11)]
    radii = (rng.rand(len(verts)) * 20 + 1).astype(np.float32)
    return dict(vertices=verts, edges=np.array(edges, dtype=np.uint32),
                radii=radii, segid=7)


POST_CASES = {
    "loop_trivial": (dict(
        vertices=[(0, 0, 0), (1, 0, 0), (4, 0, 0), (6, 0, 0), (20, 0, 0),
                  (21, 0, 0), (0, 0, 5), (0, 0, 10)],
        edges=[(0, 1), (2, 3), (4, 5), (6, 7), (0, 7), (1, 6)]),
        dict(dust_threshold=0, tick_threshold=0)),
    "random0": (_random_skeleton(0), dict(dust_threshold=50,
                                          tick_threshold=30)),
    "random1": (_random_skeleton(1), dict(dust_threshold=0,
                                          tick_threshold=80)),
    "random2_nojoin": (_random_skeleton(2), dict(dust_threshold=100,
                                                 tick_threshold=0)),
}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_postprocess_matches_jax(case, route):
    kw, call = POST_CASES[case]
    js, ts = _pair(**kw)
    want = kimimaro_tpu.postprocess(js, **call)
    got = kimimaro_tpu_torch.postprocess(ts, **call)
    _assert_same(got, want)


STEP_CASES = ("remove_dust", "remove_ticks_5", "remove_ticks_0.5",
              "remove_loops_isolated", "remove_loops_tail",
              "remove_loops_random", "remove_ticks_random")


@pytest.mark.parametrize("case", STEP_CASES)
def test_post_steps_match_jax(case, route):
    tick = dict(vertices=[(0, 0, 0), (10, 0, 0), (20, 0, 0), (30, 0, 0),
                          (10, 1, 0)],
                edges=[(0, 1), (1, 2), (2, 3), (1, 4)], radii=[1] * 5)
    if case == "remove_dust":
        kw = dict(vertices=[(0, 0, 0), (5, 0, 0), (10, 0, 0), (100, 0, 0),
                            (101, 0, 0)], edges=[(0, 1), (1, 2), (3, 4)])
        call = ("remove_dust", (5.0,))
    elif case.startswith("remove_ticks_random"):
        kw, call = _random_skeleton(3, loops=False), ("remove_ticks",
                                                       (40.0,))
    elif case.startswith("remove_ticks"):
        kw, call = tick, ("remove_ticks", (float(case.split("_")[-1]),))
    elif case == "remove_loops_isolated":
        kw = dict(vertices=[(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
                  edges=[(0, 1), (1, 2), (2, 3), (3, 0)], radii=[1] * 4)
        call = ("remove_loops", ())
    elif case == "remove_loops_tail":
        kw = dict(vertices=[(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                            (-1, 0, 0)],
                  edges=[(0, 1), (1, 2), (2, 3), (3, 0), (0, 4)],
                  radii=[1] * 5)
        call = ("remove_loops", ())
    else:
        kw, call = _random_skeleton(4), ("remove_loops", ())
    js, ts = _pair(**kw)
    want = getattr(jpost, call[0])(js, *call[1]).consolidate()
    got = getattr(tpost, call[0])(ts, *call[1]).consolidate()
    _assert_same(got, want)
    if call[0] == "remove_loops":
        assert len(tpost.find_cycle(got.edges.astype(np.int32))) == 0


@pytest.mark.parametrize("seed", (0, 5))
def test_create_distance_graph_matches_jax(seed, route):
    kw = _random_skeleton(seed)
    # one component without loops: the first tree's edges
    n = 160
    kw = dict(vertices=kw["vertices"][:n],
              edges=kw["edges"][: n - 1], radii=kw["radii"][:n])
    js, ts = _pair(**kw)
    want = jpost.create_distance_graph(js)
    got = tpost.create_distance_graph(ts)
    assert set(got) == set(want)
    g = np.array([got[k] for k in sorted(want)], dtype=np.float32)
    w = np.array([want[k] for k in sorted(want)], dtype=np.float32)
    np.testing.assert_allclose(g, w, rtol=1e-6)


def test_row_helpers_match_jax():
    arr = np.array([[0, 1], [1, 2], [2, 1], [2, 2], [2, 3], [3, 4]])
    for rows in (np.array([[1, 2]]), np.array([[2, 2], [3, 4]]),
                 np.array([[9, 9]])):
        np.testing.assert_array_equal(tpost.remove_row(arr, rows),
                                      jpost.remove_row(arr, rows))
    empty = np.array([[]])
    np.testing.assert_array_equal(
        tpost.remove_row(empty, np.array([[1, 2]])),
        jpost.remove_row(empty, np.array([[1, 2]])))
    for row in ([2, 3], [4, 4]):
        assert tpost.find_row(arr, row) == jpost.find_row(arr, row)


@pytest.mark.parametrize("case", ("line", "random"))
def test_extract_skeleton_from_binary_image_matches_jax(case):
    if case == "line":
        img = np.zeros((10, 3, 3), dtype=bool)
        img[:, 1, 1] = True
    else:
        img = np.random.RandomState(3).rand(9, 8, 7) > 0.8
    want = kimimaro_tpu.extract_skeleton_from_binary_image(img)
    got = kimimaro_tpu_torch.extract_skeleton_from_binary_image(img)
    _assert_same(got, want)
    if case == "line":
        assert got.vertices.shape[0] == 10 and got.edges.shape[0] == 9


def test_compute_cc_labels_matches_jax():
    from kimimaro_tpu import utility as jutility
    from kimimaro_tpu_torch import utility as tutility

    rng = np.random.RandomState(4)
    labels = rng.randint(0, 4, size=(14, 12, 10)).astype(np.uint32)
    labels[rng.rand(*labels.shape) < 0.5] = 0
    want = jutility.compute_cc_labels(labels)
    got = tutility.compute_cc_labels(labels, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == want[0].dtype
    assert got[1] == want[1]


# label 1614 of the dense 512^3 run (bench.py's generator, anisotropy
# (16, 16, 40)): voxel coordinates and edges. Its spurs (48, 106) and
# (48, 27) differ in length only in the last bits of a float64, so a
# float32 length would prune the other one.
_NEAR_TIE_VOX = np.array([
    57, 75, 353, 58, 75, 352, 59, 75, 352, 60, 76, 352, 61, 77, 352, 62, 77, 352,
    63, 78, 352, 64, 79, 352, 65, 80, 352, 66, 81, 352, 67, 82, 352, 68, 83, 352,
    69, 83, 352, 70, 84, 352, 71, 85, 352, 72, 86, 352, 73, 86, 352, 74, 87, 352,
    75, 88, 352, 76, 89, 352, 77, 89, 352, 78, 90, 352, 79, 91, 352, 80, 92, 352,
    81, 93, 352, 82, 94, 352, 83, 95, 352, 83, 99, 329, 84, 96, 352, 84, 98, 330,
    85, 96, 352, 85, 97, 331, 86, 96, 332, 86, 97, 352, 87, 85, 345, 87, 86, 345,
    87, 87, 345, 87, 88, 345, 87, 89, 344, 87, 89, 346, 87, 90, 346, 87, 91, 347,
    87, 92, 348, 87, 93, 349, 87, 95, 333, 87, 96, 351, 87, 98, 352, 88, 84, 345,
    88, 88, 340, 88, 89, 341, 88, 90, 342, 88, 90, 343, 88, 94, 334, 88, 94, 349,
    88, 95, 350, 88, 99, 352, 89, 82, 344, 89, 83, 344, 89, 87, 339, 89, 89, 339,
    89, 90, 338, 89, 93, 335, 89, 100, 352, 89, 101, 352, 89, 102, 352, 89, 103, 352,
    90, 79, 344, 90, 80, 344, 90, 81, 344, 90, 86, 338, 90, 91, 337, 90, 92, 336,
    90, 104, 352, 90, 105, 352, 90, 106, 352, 91, 78, 344, 91, 85, 337, 91, 107, 352,
    91, 108, 351, 91, 109, 351, 92, 76, 343, 92, 77, 343, 92, 84, 336, 92, 110, 351,
    92, 111, 351, 92, 112, 351, 93, 73, 343, 93, 74, 343, 93, 75, 343, 93, 83, 335,
    93, 113, 351, 94, 72, 343, 94, 82, 334, 94, 114, 352, 95, 70, 342, 95, 71, 342,
    95, 80, 332, 95, 81, 333, 95, 114, 352, 96, 65, 342, 96, 67, 342, 96, 68, 342,
    96, 69, 342, 96, 79, 331, 96, 115, 352, 97, 66, 341, 97, 77, 329, 97, 78, 330,
    97, 116, 351, 98, 116, 350, 99, 116, 349, 100, 116, 348, 101, 117, 347, 102, 117, 346,
    103, 117, 345, 104, 117, 344, 105, 118, 343, 106, 117, 342, 107, 118, 341, 108, 118, 340,
    109, 119, 339, 110, 119, 338, 111, 119, 337, 112, 120, 336,
]).reshape(-1, 3)
_NEAR_TIE_EDGES = np.array([
    0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
    9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18,
    18, 19, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 24, 25, 25, 26, 26, 28,
    27, 29, 28, 30, 29, 31, 30, 33, 31, 32, 32, 44, 33, 45, 33, 46, 34, 35,
    34, 47, 35, 36, 36, 37, 37, 38, 37, 39, 38, 51, 39, 40, 40, 41, 41, 42,
    42, 43, 43, 53, 44, 52, 45, 54, 46, 55, 47, 57, 48, 49, 48, 58, 48, 59,
    49, 50, 50, 51, 52, 61, 53, 54, 55, 62, 56, 57, 56, 68, 58, 69, 59, 60,
    60, 70, 61, 71, 62, 63, 63, 64, 64, 65, 65, 72, 66, 67, 66, 75, 67, 68,
    69, 76, 70, 71, 72, 73, 73, 74, 74, 77, 75, 81, 76, 82, 77, 78, 78, 79,
    79, 83, 80, 81, 80, 88, 82, 89, 83, 84, 84, 85, 85, 90, 86, 87, 86, 91,
    87, 88, 89, 92, 90, 93, 91, 95, 92, 97, 93, 98, 94, 95, 94, 102, 96, 97,
    96, 103, 98, 104, 99, 105, 100, 101, 100, 105, 101, 102, 103, 107, 104, 108, 106, 107,
    108, 109, 109, 110, 110, 111, 111, 112, 112, 113, 113, 114, 114, 115, 115, 116, 116, 117,
    117, 118, 118, 119, 119, 120, 120, 121, 121, 122, 122, 123,
]).reshape(-1, 2)


def test_postprocess_near_tied_spurs_routes_agree(route):
    """Both routes of the port take the native route's spur lengths
    (float64 sums of the float32 differences), so near-tied spurs prune
    alike on either route, as the JAX package's native route prunes
    them."""
    kw = dict(vertices=(_NEAR_TIE_VOX * [16, 16, 40]).astype(np.float32),
              edges=_NEAR_TIE_EDGES.astype(np.uint32),
              radii=np.ones(len(_NEAR_TIE_VOX), np.float32))
    call = dict(dust_threshold=1000, tick_threshold=3500)
    want = jpost.postprocess(JSkeleton(**kw), **call)
    _assert_same(tpost.postprocess(TSkeleton(**kw), **call), want)


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16, np.uint32, np.int64))
def test_native_bbox_ids_and_rle_encode_match_jax(dtype):
    """The port's copies of the native library's other two functions
    against the JAX package's library and against numpy."""
    from kimimaro_tpu import native as jnative

    assert native.available()
    rng = np.random.RandomState(6)
    labels = rng.randint(0, 5, size=(9, 7, 11)).astype(dtype)
    labels[labels == 3] = 0
    got = native.bbox_ids(labels, [1, 2, 3, 4])
    want = jnative.bbox_ids(labels, [1, 2, 3, 4])
    assert set(got) == set(want) == {1, 2, 4}
    for k in got:
        pos = np.argwhere(labels == k)
        for g, w, ref in zip(got[k], want[k], (pos.min(0), pos.max(0))):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, ref)
    flat = np.repeat(labels.ravel()[:40], rng.randint(1, 300, size=40))
    if dtype == np.int64:  # 8-byte values are not encoded
        assert native.rle_encode(flat, flat.size) is None
        return
    lengths, values = native.rle_encode(flat, flat.size)
    want_l, want_v = jnative.rle_encode(flat, flat.size)
    np.testing.assert_array_equal(lengths, want_l)
    np.testing.assert_array_equal(values, want_v)
    np.testing.assert_array_equal(np.repeat(values, lengths), flat)
    assert native.rle_encode(flat, 3) is None  # more runs than the cap

"""The global engine's selective bail: kimimaro_tpu_torch.skeletonize against
kimimaro_tpu.skeletonize on bench.py's dense Voronoi volume at 64^3 with
520 labels, bit-equal skeletons, and the same labels handed from the global
engine to the crop engine.

The JAX package reads its bail settings from KIMIMARO_TPU_GENGINE_BAIL,
_BAIL_CROP and _KEEP_FRAC; the port's are the module constants
gengine.BAIL_ACTIVE, BAIL_MIN_LIVE, BAIL_CROP and BAIL_KEEP_FRAC. Each
scenario sets both sides alike and runs once per module. In the JAX
package's pipelined loop, the bail reads iteration d's active count after
iteration d + 1 has run and hands back the labels active in d + 1; a label
that traces its last path in iteration d keeps its global-engine skeleton.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import scipy.ndimage
import torch
from scipy.spatial import cKDTree

import kimimaro_tpu
import kimimaro_tpu.engine
import kimimaro_tpu_torch
from kimimaro_tpu.utils import profiling as jax_profiling
from kimimaro_tpu_torch import engine, gengine
from kimimaro_tpu_torch.utils import profiling

torch.set_num_threads(1)

TEASAR = {  # bench.py's parameters
    "scale": 1.5,
    "const": 300,
    "pdrf_exponent": 4,
    "pdrf_scale": 100000,
    "soma_detection_threshold": 1100,
    "soma_acceptance_threshold": 3500,
}
KW = dict(anisotropy=(16, 16, 40), dust_threshold=10, fix_borders=True,
          fix_branching=True)
ROUTING = ("gengine_jobs", "gengine_fallback", "gengine_taint_capacity")

# name: (JAX environment, port constants, labels taken out of the volume,
# TEASAR's const). The bail's settings are read on the host: every
# scenario's global engine runs the same compiled JAX programs.
SCENARIOS = {
    # the JAX package's defaults: 520 live labels, more than 500
    "default": ({}, {}, 0, 300),
    # with a smaller invalidation ball, 14 labels are active after the
    # decision: those of crop 16 leave and will not iterate again, the
    # others' crops fill more than a tenth of the volume and they iterate on
    "purge": ({"KIMIMARO_TPU_GENGINE_BAIL_CROP": "16",
               "KIMIMARO_TPU_GENGINE_KEEP_FRAC": "0.1"},
              {"BAIL_CROP": 16, "BAIL_KEEP_FRAC": 0.1}, 0, 100),
    # a later decision: 2 or fewer active labels
    "late": ({"KIMIMARO_TPU_GENGINE_BAIL": "2"},
             {"BAIL_ACTIVE": 2, "BAIL_MIN_LIVE": 0}, 0, 300),
    # the defaults with exactly 500 live labels: no bail
    "min_live": ({}, {}, 20, 300),
}


def dense_volume(n=64, n_labels=520, seed=1):
    """bench.py's synthetic_volume_dense: an anisotropic Voronoi partition
    (nearest seed by KD-tree)."""
    rng = np.random.RandomState(seed)
    seeds = rng.randint(0, n, size=(n_labels, 3)).astype(np.float32)
    scale = np.array([16.0, 16.0, 40.0], dtype=np.float32)
    grid = np.stack(np.meshgrid(*(np.arange(n, dtype=np.float32) * s
                                  for s in scale), indexing="ij"), axis=-1)
    _, idx = cKDTree(seeds * scale).query(grid.reshape(-1, 3), k=1)
    return (idx.astype(np.uint32) + 1).reshape(n, n, n)


def _take_out(vol, n):
    """A copy of `vol` without the n last labels whose box exceeds 16 on an
    axis: the crop tiers' lane counts keep their powers of two, so the JAX
    package's global engine reuses its compiled programs."""
    out = vol.copy()
    boxes = scipy.ndimage.find_objects(vol)
    big = [i + 1 for i, b in enumerate(boxes)
           if max(s.stop - s.start for s in b) > 16]
    out[np.isin(out, big[len(big) - n:])] = 0
    return out


def _same_skeletons(a, b):
    assert set(a) == set(b)
    for k in a:
        sa, sb = a[k], b[k]
        oa, ob = np.lexsort(sa.vertices.T), np.lexsort(sb.vertices.T)
        np.testing.assert_array_equal(sa.vertices[oa], sb.vertices[ob])
        np.testing.assert_array_equal(sa.radii[oa], sb.radii[ob])

        def edge_set(s):
            v = s.vertices
            return {tuple(sorted((tuple(v[p]), tuple(v[q]))))
                    for p, q in s.edges}

        assert edge_set(sa) == edge_set(sb)


def _crop_spy(mp, module, into):
    """Record (segid, box shape) of each job handed to the crop engine."""
    inner = module.trace_batched

    def spy(cc, dbf, jobs, *args, **kw):
        into.extend((int(j["segid"]), tuple(int(x) for x in j["shape"]))
                    for j in jobs)
        return inner(cc, dbf, jobs, *args, **kw)

    mp.setattr(module, "trace_batched", spy)


def _iteration_spy(mp, counts, noop):
    """Record each iteration's active count; after the iteration with
    none, run one more (as the JAX package's loop does) on a copy of the
    loop state and record whether it changed anything."""
    inner = gengine._iteration

    def spy(st, it, it_w, *args):
        out = inner(st, it, it_w, *args)
        counts.append(out[0])
        if out[0] == 0 and it_w + 1 < gengine.K_ITER:
            extra = {k: v.clone() for k, v in st.items()}
            n, ball_mask, rail_mask = inner(extra, it + 1, it_w + 1, *args)
            noop.append(
                n == 0
                and all(torch.equal(extra[k], st[k]) for k in
                        ("valid", "pdrf", "d_rail", "nb", "na", "done"))
                and not extra["len_buf"][it_w + 1].any()
                and not any(m is not None and bool(m.any())
                            for m in (ball_mask, rail_mask)))
        return out

    mp.setattr(gengine, "_iteration", spy)


@pytest.fixture(scope="module")
def volume():
    return dense_volume()


@pytest.fixture(scope="module")
def runs(volume):
    """Each scenario run once on both sides, on first use."""
    done = {}

    def get(name):
        if name in done:
            return done[name]
        env, consts, drop, const = SCENARIOS[name]
        vol = _take_out(volume, drop) if drop else volume
        kw = dict(KW, teasar_params=dict(TEASAR, const=const))
        r = dict(jax_crop=[], crop=[], counts=[], noop=[])
        with pytest.MonkeyPatch.context() as mp:
            # the JAX engine prints each landed iteration's active count
            mp.setenv("KIMIMARO_TPU_GENGINE_DEBUG", "1")
            for k, v in env.items():
                mp.setenv(k, v)
            _crop_spy(mp, kimimaro_tpu.engine, r["jax_crop"])
            jax_profiling.reset_stats()
            jax_profiling.collect(True)
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    r["want"] = kimimaro_tpu.skeletonize(vol, **kw)
            finally:
                jax_profiling.collect(False)
            r["jax"] = jax_profiling.get_stats()["counters"]
            r["jax_counts"] = [int(n) for n in re.findall(
                r"\[gengine\] it=\d+ n_act=(\d+)", out.getvalue())]

            for k, v in consts.items():
                mp.setattr(gengine, k, v, raising=False)
            _crop_spy(mp, engine, r["crop"])
            _iteration_spy(mp, r["counts"], r["noop"])
            profiling.reset_stats()
            profiling.collect(True)
            try:
                r["got"] = kimimaro_tpu_torch.skeletonize(
                    vol, device="cpu", **kw)
            finally:
                profiling.collect(False)
            r["port"] = profiling.get_stats()["counters"]
        done[name] = r
        return r

    return get


def _check_parity(r):
    _same_skeletons(r["want"], r["got"])
    for k in ROUTING:
        assert r["port"][k] == r["jax"][k], k
    assert sorted(r["crop"]) == sorted(r["jax_crop"])
    assert r["port"]["crop_engine_jobs"] == len(r["jax_crop"])
    assert r["port"]["gengine_iterations"] == len(r["counts"])
    # the same active labels in every iteration; the JAX loop may run one
    # more, with none
    n = len(r["counts"])
    assert r["jax_counts"][:n] == r["counts"]
    assert r["jax_counts"][n:] in ([], [0])


def _decision(counts, bail_n):
    """The iteration whose active count the bail reads: the first d >= 1
    with at most bail_n active labels (one segment here)."""
    assert len(counts) < gengine.K_ITER
    return next(d for d in range(1, len(counts)) if counts[d] <= bail_n)


def test_bail_all_at_the_default_thresholds(runs):
    r = runs("default")
    _check_parity(r)
    live = r["port"]["gengine_jobs"] + r["port"]["gengine_fallback"]
    assert live > gengine.BAIL_MIN_LIVE
    d = _decision(r["counts"], gengine.BAIL_ACTIVE)
    # the loop stops after iteration d + 1, with its active labels handed
    # back: nothing else leaves the global engine
    assert len(r["counts"]) == d + 2
    assert r["port"]["gengine_taint_capacity"] == r["counts"][d + 1] > 0
    assert r["port"]["gengine_fallback"] == r["counts"][d + 1]


def test_purge_hands_back_small_crops_and_keeps_iterating(runs):
    r = runs("purge")
    _check_parity(r)
    d = _decision(r["counts"], gengine.BAIL_ACTIVE)
    # of the labels active after the decision, those whose box fits a crop
    # of 16 leave ...
    assert r["crop"] and all(max(shape) <= 16 for _, shape in r["crop"])
    assert r["port"]["gengine_taint_capacity"] == len(r["crop"]) \
        < r["counts"][d + 1]
    # ... and the others iterate on to the end in the global engine
    assert len(r["counts"]) > d + 3
    assert r["counts"][-1] == 0
    assert r["noop"] == [True]


@pytest.mark.parametrize("name", ("default", "late"))
def test_label_finishing_after_the_decision_stays_global(runs, name):
    r = runs(name)
    _check_parity(r)
    bail_n = {"default": 100, "late": 2}[name]
    d = _decision(r["counts"], bail_n)
    # some labels active in iteration d trace their last path there and
    # keep their global-engine skeletons; those active in d + 1 leave
    assert r["counts"][d] > r["counts"][d + 1] > 0
    assert len(r["counts"]) == d + 2
    assert r["port"]["gengine_taint_capacity"] == r["counts"][d + 1]


def test_no_bail_at_500_live_labels(runs):
    r = runs("min_live")
    _check_parity(r)
    live = r["port"]["gengine_jobs"] + r["port"]["gengine_fallback"]
    assert live == gengine.BAIL_MIN_LIVE == 500
    assert r["jax"]["gengine_taint_capacity"] == 0
    assert r["port"]["gengine_taint_capacity"] == 0
    assert r["crop"] == []
    # the active count fell below BAIL_ACTIVE at iteration 1 and on
    assert min(r["counts"][1:]) <= gengine.BAIL_ACTIVE
    # the JAX package's loop runs one iteration past the one with no active
    # label: on the port's state it changes nothing
    assert r["counts"][-1] == 0
    assert r["noop"] == [True]

"""The comparison: the program on the CPU passes it, a perturbed output and
the controls (the reference with its fields in bfloat16) fail it."""

import numpy as np
import pytest

import gen
from reference import judge, teasar
from steps import voronoi

KW = {
    "teasar_params": {"scale": 1.5, "const": 300, "pdrf_exponent": 4,
                      "pdrf_scale": 100000, "soma_detection_threshold": 1100,
                      "soma_acceptance_threshold": 3500,
                      "soma_invalidation_scale": 2,
                      "soma_invalidation_const": 300},
    "anisotropy": [16, 16, 40], "dust_threshold": 100, "fix_borders": True,
    "fix_branching": True,
}


@pytest.fixture(scope="module")
def case():
    import kimimaro_tpu_torch

    # labels of about 8,000 voxels, a tenth of a 512^3 cell's, with enough
    # branches that the control's paths part from the reference's
    base = voronoi.voronoi([64, 64, 32], 16, [16, 16, 40], 9, "cpu")
    chunks = gen.Chunks(base, 77)
    chunk, lut = chunks.next()
    skels = kimimaro_tpu_torch.skeletonize(chunk, device="cpu", **KW)
    pool = judge.make_pool()
    try:
        ref = judge.Reference(base.numpy(), None, KW, pool)
        labels = sorted(ref.surviving)
        refs = ref.skeletons(labels)
        low = {p: ref.skeletons(labels, precision=p)
               for p in ("bfloat16", "bfloat16-paths")}
    finally:
        pool.close()
        pool.join()
    return chunk, lut, skels, ref, labels, refs, low


def _check(case, skels=None, control=None):
    chunk, lut, got, ref, labels, refs, _ = case
    return judge.check([lut], [skels or got], ref,
                       [(0, lab) for lab in labels], refs, control=control)


def _excess(case, skels=None, control=None):
    """The largest path excess of the sampled labels (a logged detail)."""
    chunk, lut, got, ref, labels, refs, _ = case
    details = []
    judge.check([lut], [skels or got], ref, [(0, lab) for lab in labels],
                refs, control=control, details=details)
    return max(d[-1] for d in details)


def test_the_program_passes(case):
    numbers = _check(case)
    assert judge.passes(numbers), numbers
    assert numbers["radius_gap"] < 1e-6
    assert _excess(case) < 1e-6


def test_the_control_fails(case):
    every = _check(case, control=case[6]["bfloat16"])
    assert not judge.passes(every)
    assert every["radius_gap"] > 1e-3
    # the paths' fields alone below float32: the radii hold, and the
    # paths that part from the reference's are dearer under its PDRF
    paths = case[6]["bfloat16-paths"]
    assert _check(case, control=paths)["radius_gap"] < 1e-6
    assert _excess(case, control=paths) > 1e-5


def _copy(skels):
    out = {}
    for k, s in skels.items():
        c = type(s)()
        c.vertices, c.edges, c.radii = (s.vertices.copy(), s.edges.copy(),
                                        s.radii.copy())
        out[k] = c
    return out


def test_a_perturbed_radius_fails(case):
    skels = _copy(case[2])
    k = sorted(skels)[0]
    skels[k].radii = skels[k].radii * np.float32(1.001)
    assert _check(case, skels)["radius_gap"] > judge.LIMITS["radius_gap"]


def test_a_moved_vertex_fails(case):
    skels = _copy(case[2])
    k = sorted(skels)[1]
    # three voxel steps: two or more from any vertex it was joined to
    skels[k].vertices[0] += np.float32(3 * 16)
    assert _check(case, skels)["stray_parts"] > 0


def test_a_dropped_branch_fails(case):
    skels = _copy(case[2])
    k = max(skels, key=lambda k: len(skels[k].vertices))
    skels[k].vertices = skels[k].vertices[:1]
    skels[k].radii = skels[k].radii[:1]
    skels[k].edges = skels[k].edges[:0]
    assert _check(case, skels)["uncovered"] > 0


def test_a_rerouted_branch_reads_a_path_excess(case):
    # two interior vertices of the longest branch, a third and two thirds
    # along it, each moved to the dearest voxel of the component next to
    # both of its neighbours: still a path of 26-moves, no longer the
    # cheapest, nor two cheapest paths joined end to end
    chunk, lut, got, ref, labels, refs, _ = case
    skels = _copy(got)
    lab = max(labels, key=lambda b: len(got[int(lut[b])].vertices))
    s = skels[int(lut[lab])]
    comp = refs[lab][0]
    v, e, _ = judge._voxels(s, KW["anisotropy"])
    chain = max(judge.branches(len(v), e), key=len)
    taken = {tuple(x) for x in v}
    offs = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3), -1).reshape(-1, 3)
    def dearest(at):
        i, a, b = chain[at], chain[at - 1], chain[at + 1]
        best = None
        for o in offs:
            w = v[i] + o
            q = w - comp["lo"]
            if tuple(w) in taken or (q < 0).any() or \
                    (q >= comp["fg"].shape).any() or not comp["fg"][tuple(q)]:
                continue
            if max(np.abs(w - v[a]).max(), np.abs(w - v[b]).max()) > 1:
                continue
            cost = comp["pdrf"][np.ravel_multi_index(tuple(q),
                                                     comp["fg"].shape)]
            if best is None or cost > best[0]:
                best = (cost, w)
        return None if best is None else best[1]

    moved = []
    for third in (1, 2):
        want = third * len(chain) // 3
        # the interior vertex nearest a third of the way that can move
        for at in sorted(range(1, len(chain) - 1),
                         key=lambda k: abs(k - want)):
            w = dearest(at)
            if w is not None and all(abs(at - m) > 2 for m in moved):
                s.vertices[chain[at]] = (w * np.asarray(KW["anisotropy"])
                                         ).astype(np.float32)
                moved.append(at)
                break
    assert len(moved) == 2
    assert _check(case, skels)["stray_parts"] == 0
    assert _excess(case, skels) > 1e-4


def test_branches_split_at_every_vertex_of_another_degree():
    #   0 - 1 - 2 - 3       a fork at 2, a loop of degree-2 vertices apart
    #           |
    #           4 - 5       7 - 8 - 9 - 7
    e = [(0, 1), (1, 2), (2, 3), (2, 4), (4, 5), (7, 8), (8, 9), (9, 7),
         (3, 2)]
    got = sorted(tuple(c) if c[0] < c[-1] else tuple(c[::-1])
                 for c in judge.branches(10, e))
    assert got == [(0, 1, 2), (2, 3), (2, 4, 5)]


def test_an_option_the_reference_does_not_implement_is_refused():
    with pytest.raises(ValueError, match="fill_holes"):
        judge.option_modules({**KW, "fill_holes": True})
    with pytest.raises(ValueError, match="max_paths"):
        judge.option_modules({**KW, "teasar_params": {
            **KW["teasar_params"], "max_paths": 3}})
    assert judge.option_modules(KW) == {}


def test_a_missing_label_fails(case):
    skels = _copy(case[2])
    del skels[sorted(skels)[2]]
    assert _check(case, skels)["labels_off"] == 1


def test_bfloat16_rounding_is_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, np.inf, 257.0])
    got = teasar._round(x, "bfloat16")
    assert list(got) == [1.0, 1.0, 1.0 + 2 ** -6, np.inf, 256.0]

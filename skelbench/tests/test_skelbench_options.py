"""The reference's `fill_holes` and `fix_avocados` (`reference/options/`)
against the port's host stages on the CPU, voxel for voxel in original
labels, and under a relabelling of the ids. The volume is
`chip_smoke.small_fill_volume`: a hollow 64^3 Voronoi volume with a pit
on a face (an avocado) and a hollow box (a hole)."""

import sys

import numpy as np
import pytest
import torch

from conftest import REPO

if REPO not in sys.path:
    sys.path.insert(0, REPO)

from reference.options import fill_holes, fix_avocados  # noqa: E402

ANIS = (16, 16, 40)


@pytest.fixture(scope="module")
def volume():
    import chip_smoke

    return chip_smoke.small_fill_volume().astype(np.uint32)


def _port(vol, sdt):
    """(the port's filled volume, its protected volume), each in original
    labels, and the port's component ids."""
    from kimimaro_tpu_torch import gengine, intake
    from kimimaro_tpu_torch.ops import edt
    from kimimaro_tpu_torch.ops.ccl import compact_cc, connected_components

    cc, n, _ = compact_cc(connected_components(
        torch.from_numpy(vol.view(np.int32))))
    first = gengine._first_voxels(cc, n + 1).numpy()
    remap = {u: int(vol.reshape(-1)[first[u]]) for u in range(1, n + 1)}
    cc = cc.numpy()
    filled = intake.fill_all_holes(cc, device="cpu")

    def edtfn(lab):
        return edt.edt(torch.from_numpy(lab.astype(np.int32)), ANIS,
                       False).numpy()

    out, _, remap_out = intake.engage_avocado_protection(
        filled, edtfn(filled), remap, sdt, edtfn, device="cpu")

    def original(ids, table):
        lut = np.zeros(int(ids.max()) + 1, np.int64)
        for k, v in table.items():
            if k < len(lut):
                lut[k] = v
        return lut[ids]

    return original(filled, remap), original(out, remap_out), cc


# 1100 is the configuration's threshold; 300 makes the face pit and more
# components candidates of the avocado passes
@pytest.mark.parametrize("sdt", [1100, 300])
def test_prepare_equals_the_port_voxel_for_voxel(volume, sdt):
    want_fill, want_avocado, cc = _port(volume, sdt)
    ids, owner = fill_holes.scan_components(volume)
    np.testing.assert_array_equal(ids, cc)      # scan order is the port's
    got_fill, graph = fill_holes.prepare(volume, None, True)
    assert graph is None
    np.testing.assert_array_equal(got_fill, want_fill)
    assert (got_fill != volume).sum() > 0       # a hole was filled
    got, _ = fix_avocados.prepare(got_fill, None, True, anisotropy=ANIS,
                                  soma_detection_threshold=sdt)
    np.testing.assert_array_equal(got, want_avocado)
    assert len(np.unique(got)) < len(np.unique(got_fill))   # one absorbed


@pytest.mark.parametrize("option", ["fill_holes", "fix_avocados"])
def test_prepare_is_the_same_under_a_relabelling(volume, option):
    mod = {"fill_holes": fill_holes, "fix_avocados": fix_avocados}[option]
    kw = {} if option == "fill_holes" else dict(
        anisotropy=ANIS, soma_detection_threshold=300)
    lut = np.zeros(int(volume.max()) + 1, np.uint32)
    lut[1:] = np.random.default_rng(7).permutation(len(lut) - 1) + 1
    base, _ = mod.prepare(volume, None, True, **kw)
    moved, _ = mod.prepare(lut[volume], None, True, **kw)
    np.testing.assert_array_equal(moved, lut[base])


def test_prepare_leaves_a_false_option_alone(volume):
    for mod in (fill_holes, fix_avocados):
        got, graph = mod.prepare(volume, None, False)
        assert got is volume and graph is None


def test_fix_avocados_needs_its_configuration_outside_the_judge(volume):
    with pytest.raises(ValueError, match="anisotropy"):
        fix_avocados.prepare(volume, None, True)


@pytest.mark.parametrize("seed", [0, 1])
def test_rays_and_walls_equal_the_ports(seed):
    # the avocado pass's pieces on random labels (background pits among
    # them) and random masks, degenerate boxes included
    from kimimaro_tpu_torch import intake

    rng = np.random.default_rng(seed)
    for _ in range(100):
        lab = rng.integers(0, 4, size=(7, 6, 5))
        for p in rng.integers(0, (7, 6, 5), size=(6, 3)):
            pit, fruit = intake.find_avocado_fruit(lab, *p)
            assert fix_avocados.fruit_of(lab, p) == (int(pit), int(fruit))
        shape = tuple(int(x) for x in rng.integers(1, 9, size=3))
        mask = rng.random(shape) > 0.35
        np.testing.assert_array_equal(
            fix_avocados.paint_walls(mask.copy()),
            intake._paint_walls(mask.copy(), torch.device("cpu")))

"""The port's CLI (kimimaro_tpu_torch.cli, argparse) against the JAX
package's (kimimaro_tpu.cli, click): the twins of tests/test_cli.py, and
the SWC files both CLIs write for the same .npy / .npy.gz input, byte for
byte (the port on the CPU through `main([... "--device", "cpu"])`)."""

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from click.testing import CliRunner

from kimimaro_tpu.cli import main as jmain
from kimimaro_tpu_torch.cli import codecs, main
from kimimaro_tpu_torch.skeleton import Skeleton

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bar_labels():
    labels = np.zeros((48, 48, 8), dtype=np.uint32)
    labels[8:40, 20:28, 2:6] = 9
    return labels


def _two_labels():
    labels = _bar_labels()
    labels[10:20, 4:12, 1:7] = 4
    return labels


def _save(path, arr):
    if str(path).endswith(".gz"):
        buf = io.BytesIO()
        np.save(buf, arr)
        with gzip.open(path, "wb") as f:
            f.write(buf.getvalue())
    else:
        np.save(path, arr)


def test_forge(tmp_path, capsys):
    src = tmp_path / "labels.npy"
    np.save(src, _bar_labels())
    outdir = tmp_path / "out"
    rc = main(["forge", str(src), "--scale", "2", "--const", "40",
               "--dust", "10", "--no-fill-holes", "-o", str(outdir),
               "--progress", "--device", "cpu"])
    assert rc == 0
    assert "9.swc" in os.listdir(outdir)
    assert "wrote 1 skeletons" in capsys.readouterr().out
    skel = Skeleton.from_swc(open(outdir / "9.swc").read())
    assert skel.vertices.shape[0] > 5


@pytest.mark.parametrize("name,options", [
    ("labels.npy", ["--scale", "2", "--const", "40", "--no-fill-holes"]),
    ("labels.npy.gz", ["--anisotropy", "16,16,40", "--fix-borders",
                       "--no-fill-holes", "-p", "2"]),
    ("labels.npy", ["--scale", "1.5", "--const", "300", "--fill-holes",
                    "--max-paths", "3"]),
])
def test_forge_writes_the_jax_cli_swc_bytes(tmp_path, name, options):
    src = tmp_path / name
    _save(src, _two_labels())
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    result = CliRunner().invoke(jmain, ["forge", str(src), "--dust", "10",
                                        "-o", str(want_dir)] + options)
    assert result.exit_code == 0, result.output
    rc = main(["forge", str(src), "--dust", "10", "-o", str(got_dir),
               "--device", "cpu"] + options)
    assert rc == 0
    want = sorted(os.listdir(want_dir))
    assert want == sorted(os.listdir(got_dir)) == ["4.swc", "9.swc"]
    for fn in want:
        assert (got_dir / fn).read_bytes() == (want_dir / fn).read_bytes()


def test_forge_with_cuda_where_there_is_none_fails_cleanly(tmp_path,
                                                           capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    src = tmp_path / "labels.npy"
    np.save(src, _bar_labels())
    outdir = tmp_path / "out"
    rc = main(["forge", str(src), "--dust", "10", "-o", str(outdir),
               "--device", "cuda"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not outdir.exists()


def test_forge_rejects_a_bad_anisotropy(tmp_path, capsys):
    rc = main(["forge", str(tmp_path / "x.npy"), "--anisotropy", "1,2",
               "--device", "cpu"])
    assert rc == 2
    assert "comma delimited list of 3 integers" in capsys.readouterr().err


def test_swc_roundtrip(tmp_path):
    skel = Skeleton(
        [(0, 0, 0), (1, 1, 0), (2, 2, 0), (2, 3, 0)],
        edges=[(0, 1), (1, 2), (1, 3)],
        radii=[1, 2, 3, 4],
    )
    swc = skel.to_swc()
    back = Skeleton.from_swc(swc)
    assert Skeleton.equivalent(skel, back)
    assert np.allclose(sorted(back.radii), sorted(skel.radii))


def test_swc_from_to(tmp_path):
    img = np.zeros((20, 3, 3), dtype=bool)
    img[:, 1, 1] = True
    img[5, 0, 0] = True
    src = tmp_path / "skel_img.npy"
    np.save(src, img)

    assert main(["swc", "from", str(src)]) == 0
    swc_path = tmp_path / "skel_img.swc"
    assert swc_path.exists()
    # the JAX CLI writes the same SWC for the same image
    jdir = tmp_path / "jax"
    jdir.mkdir()
    np.save(jdir / "skel_img.npy", img)
    result = CliRunner().invoke(jmain, ["swc", "from",
                                        str(jdir / "skel_img.npy")])
    assert result.exit_code == 0, result.output
    assert swc_path.read_bytes() == (jdir / "skel_img.swc").read_bytes()

    assert main(["swc", "to", str(swc_path)]) == 0
    img2 = np.load(tmp_path / "skel_img.npy")
    assert img2.any()
    result = CliRunner().invoke(jmain, ["swc", "to",
                                        str(jdir / "skel_img.swc")])
    assert result.exit_code == 0, result.output
    np.testing.assert_array_equal(img2, np.load(jdir / "skel_img.npy"))


def test_license(capsys):
    assert main(["license"]) == 0
    out = capsys.readouterr().out
    assert "MIT" in out or "Permission" in out


@pytest.mark.parametrize("argv", [[], ["swc"]])
def test_group_without_a_command_prints_help(argv, capsys):
    want = CliRunner().invoke(jmain, argv)
    assert main(argv) == want.exit_code
    out = capsys.readouterr().out
    assert "usage:" in out
    if argv:
        assert "from" in out and "to" in out


def test_swc_to_tiff(tmp_path, capsys):
    skel = Skeleton(
        [(0, 0, 0), (1, 1, 1), (2, 2, 2)], edges=[(0, 1), (1, 2)],
        radii=[1, 1, 1],
    )
    src = tmp_path / "x.swc"
    src.write_text(skel.to_swc())

    assert main(["swc", "to", str(src), "--format", "tiff"]) == 0
    out = capsys.readouterr().out
    try:
        import tifffile  # noqa: F401

        assert (tmp_path / "x.tiff").exists()
    except ImportError:
        assert "tifffile" in out
        assert not (tmp_path / "x.tiff").exists()

    assert main(["swc", "to", str(src), "--format", "bmp"]) == 0
    assert "invalid format" in capsys.readouterr().out


def test_codecs_save_errors(tmp_path):
    arr = np.zeros((4, 4, 4), dtype=np.uint8)
    codecs.save(str(tmp_path / "a.npy"), arr)
    assert np.array_equal(codecs.load(str(tmp_path / "a.npy")), arr)
    codecs.save(str(tmp_path / "a.npy.gz"), arr)
    assert np.array_equal(codecs.load(str(tmp_path / "a.npy.gz")), arr)

    for name, pkg in [("a.ckl", "crackle"), ("a.nrrd", "pynrrd"),
                      ("a.nii", "nibabel"), ("a.tif", "tifffile")]:
        try:
            codecs.save(str(tmp_path / name), arr)
        except ImportError as e:
            assert pkg in str(e)

    with pytest.raises(ValueError):
        codecs.save(str(tmp_path / "a.weird"), arr)


def test_view_degrades_without_microviewer(tmp_path, capsys):
    vol = tmp_path / "v.npy"
    np.save(vol, np.zeros((3, 3, 3), np.uint8))
    assert main(["view", str(vol)]) == 0
    try:
        import microviewer  # noqa: F401
    except ImportError:
        assert "microviewer" in capsys.readouterr().out


def test_module_entry_point_imports_neither_jax_nor_click(tmp_path):
    """`python -m kimimaro_tpu_torch.cli` runs, and the port's CLI loads
    no jax, click or kimimaro_tpu module."""
    code = ("import sys, runpy; sys.argv = ['kimimaro-tpu-torch', "
            "'license']\n"
            "try:\n    runpy.run_module('kimimaro_tpu_torch.cli', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'click', 'kimimaro_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "MIT" in out.stdout or "Permission" in out.stdout

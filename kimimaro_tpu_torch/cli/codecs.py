"""Extension-sniffing volume loaders/savers for the CLI (the port's own
copy of kimimaro_tpu.cli.codecs): .npy / .npy.gz / .ckl (crackle) /
.nrrd / .nii / .tif/.tiff. Optional formats degrade with a clear error
when their codec package is absent.
"""

from __future__ import annotations

import gzip
import io
import os

import numpy as np


def normalize_file_ext(filename: str) -> str:
    filename, ext = os.path.splitext(filename)
    if ext == ".gz":
        filename, ext2 = os.path.splitext(filename)
        ext = ext2 + ext
    while ext in (".ckl",):
        filename, ext2 = os.path.splitext(filename)
        if ext2 == "":
            break
        ext = ext2
    return ext


def load(path: str) -> np.ndarray:
    """Load a labeled volume from npy/npy.gz/ckl/nrrd/nii/tif."""
    ext = normalize_file_ext(path)

    if path.endswith(".npy.gz"):
        with gzip.open(path, "rb") as f:
            return np.load(io.BytesIO(f.read()))
    if ext == ".npy":
        return np.load(path)
    if ext == ".ckl" or path.endswith(".ckl.gz"):
        try:
            import crackle
        except ImportError as e:
            raise ImportError(
                "crackle-codec is required to read .ckl files"
            ) from e
        return crackle.load(path)
    if ext == ".nrrd":
        try:
            import nrrd
        except ImportError as e:
            raise ImportError("pynrrd is required to read .nrrd files") from e
        data, _ = nrrd.read(path)
        return data
    if ext in (".nii", ".nii.gz"):
        try:
            import nibabel as nib
        except ImportError as e:
            raise ImportError("nibabel is required to read .nii files") from e
        return np.asarray(nib.load(path).dataobj)
    if ext in (".tif", ".tiff"):
        try:
            import tifffile
        except ImportError as e:
            raise ImportError("tifffile is required to read .tif files") from e
        return tifffile.imread(path)

    raise ValueError(f"Unsupported file format: {path}")


def save(path: str, arr: np.ndarray) -> None:
    """Save a volume by extension: npy/npy.gz always; ckl/nrrd/nii/tif when
    the codec package is installed (clear ImportError otherwise); anything
    else is a ValueError (reference codecs.py analogue of load)."""
    ext = normalize_file_ext(path)
    if path.endswith(".npy.gz"):
        buf = io.BytesIO()
        np.save(buf, arr)
        with gzip.open(path, "wb") as f:
            f.write(buf.getvalue())
        return
    if ext == ".npy":
        np.save(path, arr)
        return
    if ext == ".ckl" or path.endswith(".ckl.gz"):
        try:
            import crackle
        except ImportError as e:
            raise ImportError(
                "crackle-codec is required to write .ckl files"
            ) from e
        crackle.save(arr, path)
        return
    if ext == ".nrrd":
        try:
            import nrrd
        except ImportError as e:
            raise ImportError("pynrrd is required to write .nrrd files") from e
        nrrd.write(path, arr)
        return
    if ext in (".nii", ".nii.gz"):
        try:
            import nibabel as nib
        except ImportError as e:
            raise ImportError("nibabel is required to write .nii files") from e
        nib.save(nib.Nifti1Image(arr, affine=np.eye(4)), path)
        return
    if ext in (".tif", ".tiff"):
        try:
            import tifffile
        except ImportError as e:
            raise ImportError("tifffile is required to write .tif files") from e
        tifffile.imwrite(path, arr)
        return
    raise ValueError(f"Unsupported output format: {path}")

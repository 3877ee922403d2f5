"""kimimaro_tpu_torch command line interface.

The commands of kimimaro_tpu.cli on the port: `forge` skeletonizes a
volume to SWC files (optionally with cross-section analysis), `swc
from/to` converts between binary images and SWC, `view` visualizes (when
microviewer is installed), `license` prints the license. Same command
names, arguments, options, defaults and messages, plus `--device` (the
port's `device` argument, default cuda).

Built on argparse from the standard library, so it runs wherever the port
runs (click is not needed). Run as `python -m kimimaro_tpu_torch.cli ...`
or through the `kimimaro-tpu-torch` console script; `main(argv)` returns
the exit code.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from . import codecs


def tuple3(value):
    """3 comma-separated integers (the JAX CLI's Tuple3 type)."""
    if isinstance(value, str):
        try:
            value = tuple(map(int, value.split(",")))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"'{value}' does not contain a comma delimited list of 3 "
                "integers.")
        if len(value) != 3:
            raise argparse.ArgumentTypeError(
                f"'{value}' does not contain a comma delimited list of 3 "
                "integers.")
    return value


_DESCRIPTION = """Skeletonize all labels in a segmented volumetric image
with a TEASAR-based algorithm on PyTorch/CUDA and output SWC.

Does not accept continuously valued images such as raw microscopy.

Input formats: npy, npy.gz (ckl/nrrd/nii/tif when codecs installed)."""


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kimimaro-tpu-torch", description=_DESCRIPTION,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command")

    f = sub.add_parser("forge", help="Skeletonize an input image and write "
                                     "out SWCs.",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    f.add_argument("src")
    f.add_argument("--scale", type=float, default=4,
                   help="Multiple of boundary distance added to the "
                        "invalidation zone.")
    f.add_argument("--const", type=float, default=10,
                   help="Constant physical distance added to the "
                        "invalidation zone.")
    f.add_argument("--pdrf-scale", type=int, default=100000,
                   help="Constant multiplier of the penalty field.")
    f.add_argument("--pdrf-exponent", type=int, default=4,
                   help="Exponent of the penalty field (powers of two are "
                        "faster).")
    f.add_argument("--soma-detect", type=float, default=750,
                   help="DBF threshold that triggers the more expensive "
                        "soma check.")
    f.add_argument("--soma-accept", type=float, default=1100,
                   help="DBF threshold that triggers special soma "
                        "processing.")
    f.add_argument("--soma-scale", type=float, default=2,
                   help="Multiple of boundary distance for the soma "
                        "invalidation zone.")
    f.add_argument("--soma-const", type=float, default=300,
                   help="Constant physical distance for the soma "
                        "invalidation zone.")
    f.add_argument("--anisotropy", type=tuple3, default=(1, 1, 1),
                   help="Physical size of a voxel along x,y,z.")
    f.add_argument("--dust", type=int, default=1000,
                   help="Skip connected components smaller than this many "
                        "voxels.")
    f.add_argument("--progress", action="store_true", default=False)
    f.add_argument("--fill-holes", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Fill holes in each connected component.")
    f.add_argument("--fix-avocados", action="store_true", default=False,
                   help="Combine separately-labeled nuclei with their cell "
                        "bodies.")
    f.add_argument("--fix-borders", action="store_true", default=False,
                   help="Pin skeleton endpoints where shapes touch the "
                        "border.")
    f.add_argument("--fix-branches", action="store_true", default=True,
                   help="Improve quality of forked shapes.")
    f.add_argument("--max-paths", type=int, default=None,
                   help="Maximum number of paths to trace per object.")
    f.add_argument("-p", "--parallel", type=int, default=1,
                   help="Accepted for parity; the device parallelizes "
                        "labels.")
    f.add_argument("-o", "--outdir", type=str, default="kimimaro_out",
                   help="Where to write the SWC files.")
    f.add_argument("--cross-section", type=int, default=0,
                   help="Cross-section analysis normal smoothing window, "
                        "0=off.")
    f.add_argument("--device", type=str, default="cuda",
                   help="Where the port computes: cuda or cpu.")

    s = sub.add_parser("swc", help="Utilities for managing SWC files. Use "
                                   "forge to create skeletons.")
    s.set_defaults(print_help=s.print_help)
    ssub = s.add_subparsers(dest="swc_command")
    fr = ssub.add_parser("from", help="Convert an already-thinned binary "
                                      "image into an SWC.")
    fr.add_argument("src", nargs="*")
    to = ssub.add_parser("to", help="Convert an SWC into a binary image.",
                         formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    to.add_argument("src", nargs="*")
    to.add_argument("--format", dest="fmt", type=str, default="npy",
                    help="Output format: npy or tiff.")

    v = sub.add_parser("view", help="Visualize a .swc or .npy file "
                                    "(requires microviewer).",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    v.add_argument("filename")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--color-by", type=str, default="r",
                   help="r = radius, c = components, x = cross sectional "
                        "area.")

    sub.add_parser("license", help="Print the license for this library and "
                                   "CLI tool.")
    return parser


def forge(args) -> int:
    """Skeletonize an input image and write out SWCs."""
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.intake import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"kimimaro_tpu_torch: {e}", file=sys.stderr)
        return 1
    labels = codecs.load(args.src)

    skels = kimimaro_tpu_torch.skeletonize(
        labels,
        teasar_params={
            "scale": args.scale,
            "const": args.const,
            "pdrf_scale": args.pdrf_scale,
            "pdrf_exponent": args.pdrf_exponent,
            "soma_detection_threshold": args.soma_detect,
            "soma_acceptance_threshold": args.soma_accept,
            "soma_invalidation_scale": args.soma_scale,
            "soma_invalidation_const": args.soma_const,
            "max_paths": args.max_paths,
        },
        anisotropy=args.anisotropy,
        dust_threshold=args.dust,
        progress=args.progress,
        fill_holes=args.fill_holes,
        fix_avocados=args.fix_avocados,
        fix_branching=args.fix_branches,
        fix_borders=args.fix_borders,
        parallel=args.parallel,
        device=device,
    )

    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    for label, skel in skels.items():
        with open(os.path.join(outdir, f"{label}.swc"), "wt") as f:
            f.write(skel.to_swc())

    if args.progress:
        print(f"kimimaro_tpu: wrote {len(skels)} skeletons to {outdir}")

    if args.cross_section > 0:
        skels = kimimaro_tpu_torch.cross_sectional_area(
            labels, skels,
            anisotropy=args.anisotropy,
            progress=args.progress,
            smoothing_window=args.cross_section,
            fill_holes=args.fill_holes,
            device=device,
        )
        for label, skel in skels.items():
            np.save(os.path.join(outdir, f"{label}_xs_area.npy"),
                    skel.cross_sectional_area)
            np.save(os.path.join(outdir, f"{label}_xs_area_contacts.npy"),
                    skel.cross_sectional_area_contacts)
        if args.progress:
            print(f"Wrote cross sectional areas and contacts to {outdir}")
    return 0


def from_image(args) -> int:
    """Convert an already-thinned binary image into an SWC."""
    from kimimaro_tpu_torch import extract_skeleton_from_binary_image

    for srcpath in args.src:
        try:
            image = codecs.load(srcpath)
        except ImportError:
            print(f"kimimaro_tpu: {srcpath} format not installed.")
            return 0
        skel = extract_skeleton_from_binary_image(image)
        basename, _ = os.path.splitext(srcpath)
        with open(f"{basename}.swc", "wt") as f:
            f.write(skel.to_swc())
    return 0


def to_image(args) -> int:
    """Convert an SWC into a binary image."""
    from kimimaro_tpu_torch.skeleton import Skeleton

    fmt = args.fmt
    if fmt not in ("npy", "tiff"):
        print(f"kimimaro_tpu: invalid format {fmt}. npy or tiff allowed.")
        return 0

    for srcpath in args.src:
        with open(srcpath, "rt") as f:
            skel = Skeleton.from_swc(f.read())

        minpt = np.floor(skel.vertices.min(axis=0)).astype(int)
        maxpt = np.ceil(skel.vertices.max(axis=0)).astype(int) + 1
        image = np.zeros(tuple((maxpt - minpt).tolist()), dtype=bool)
        drawpts = (skel.vertices - minpt).round().astype(int)
        image[drawpts[:, 0], drawpts[:, 1], drawpts[:, 2]] = True

        basename, _ = os.path.splitext(srcpath)
        if fmt == "npy":
            np.save(f"{basename}.npy", image)
        else:
            try:
                import tifffile
            except ImportError:
                print("kimimaro_tpu: tifffile not installed.")
                return 0
            tifffile.imwrite(
                f"{basename}.tiff",
                image.astype(np.float32, copy=False),
                photometric="minisblack",
                metadata={"axes": "ZYX"},
                imagej=True,
            )
    return 0


def view(args) -> int:
    """Visualize a .swc or .npy file (requires microviewer)."""
    from kimimaro_tpu_torch.skeleton import Skeleton

    try:
        import microviewer
    except ImportError:
        print("kimimaro_tpu: microviewer is not installed in this "
              "environment.")
        return 0

    filename = args.filename
    _, ext = os.path.splitext(filename)
    if ext == ".swc":
        with open(filename, "rt") as f:
            skel = Skeleton.from_swc(f.read())
        microviewer.objects([skel], skeleton_color_by=args.color_by)
        return 0
    try:
        labels = codecs.load(filename)
    except ImportError as e:
        print(f"kimimaro_tpu: {e}")
        return 0
    except ValueError:
        print(f"kimimaro_tpu: {filename} was not a viewable format "
              "(.swc or a volume: .npy/.npy.gz/.ckl/.nrrd/.nii/.tif).")
        return 0
    microviewer.view(labels, seg=True, port=args.port)
    return 0


def license(args=None) -> int:
    """Print the license for this library and CLI tool."""
    path = os.path.join(os.path.dirname(__file__), "..", "..", "LICENSE")
    path = os.path.abspath(path)
    if os.path.exists(path):
        with open(path, "rt") as f:
            print(f.read())
    else:
        print("MIT (see repository LICENSE)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """Run the command line `argv` (default sys.argv[1:]); returns the
    exit code (2 for a usage error, as argparse reports it, and for a
    group given no command, whose help is printed)."""
    parser = _parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.command == "forge":
        return forge(args)
    if args.command == "swc":
        if args.swc_command == "from":
            return from_image(args)
        if args.swc_command == "to":
            return to_image(args)
        args.print_help()
        return 2
    if args.command == "view":
        return view(args)
    if args.command == "license":
        return license(args)
    parser.print_help()
    return 2

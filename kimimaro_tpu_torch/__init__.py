"""kimimaro_tpu_torch: TEASAR skeletonization of densely labeled 3D
segmentation volumes on PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

The counterpart of the JAX package kimimaro_tpu, with its 14 public names.
`skeletonize`, `cross_sectional_area`, `cross_sectional_area_single`,
`connect_points` and `oversegment` take the same arguments plus `device`
("cuda" or "cpu"); `postprocess`, `join_close_components`,
`CompressedLabelVolume`, `extract_skeleton_from_binary_image` and
`synapses_to_targets` are host code. The CUDA kernels are built
from csrc/ at first use (see kimimaro_tpu_torch.kernels); importing the
package touches neither CUDA nor the compiler.
"""

from .intake import (
    DEFAULT_TEASAR_PARAMS,
    DimensionError,
    connect_points,
    skeletonize,
    synapses_to_targets,
)
from .post import join_close_components, postprocess
from .carray import CompressedLabelVolume
from .skeleton import Skeleton
from .utility import extract_skeleton_from_binary_image, moving_average
from .oversegment import oversegment
from .xsection import cross_sectional_area, cross_sectional_area_single

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_TEASAR_PARAMS",
    "DimensionError",
    "Skeleton",
    "CompressedLabelVolume",
    "connect_points",
    "cross_sectional_area",
    "cross_sectional_area_single",
    "extract_skeleton_from_binary_image",
    "join_close_components",
    "moving_average",
    "oversegment",
    "postprocess",
    "skeletonize",
    "synapses_to_targets",
]

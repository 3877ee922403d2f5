"""kimimaro_tpu_torch: TEASAR skeletonization of densely labeled 3D
segmentation volumes on PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

The counterpart of the JAX package kimimaro_tpu. `skeletonize`,
`cross_sectional_area` and `cross_sectional_area_single` take the same
arguments plus `device` ("cuda" or "cpu"). The CUDA kernels are built
from csrc/ at first use (see kimimaro_tpu_torch.kernels); importing the
package touches neither CUDA nor the compiler.
"""

from .intake import DEFAULT_TEASAR_PARAMS, DimensionError, skeletonize
from .skeleton import Skeleton
from .utility import moving_average
from .xsection import cross_sectional_area, cross_sectional_area_single

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_TEASAR_PARAMS",
    "DimensionError",
    "Skeleton",
    "cross_sectional_area",
    "cross_sectional_area_single",
    "moving_average",
    "skeletonize",
]

"""Voxel-grid operators of the port: plane sweeps (gsweep, sweep,
voronoi), CCL, EDT, crop argmax, shortest-path fields and hole filling.
The names below are those of kimimaro_tpu.ops."""
from . import ccl, edt, fill, geodesic, stencils
from .ccl import connected_components, renumber_cc
from .edt import edt as edt_transform
from .edt import edtsq
from .fill import fill as fill_voids
from .geodesic import (
    distance_field,
    euclidean_distance_field,
    flood_fill,
    invalidation_ball,
    invalidation_cube,
    parent_field,
    voronoi_feature_field,
)

__all__ = [
    "ccl",
    "edt",
    "fill",
    "geodesic",
    "stencils",
    "connected_components",
    "renumber_cc",
    "edt_transform",
    "edtsq",
    "fill_voids",
    "distance_field",
    "euclidean_distance_field",
    "flood_fill",
    "invalidation_ball",
    "invalidation_cube",
    "parent_field",
    "voronoi_feature_field",
]

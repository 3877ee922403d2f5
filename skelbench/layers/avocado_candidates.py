"""Candidates a chunk's avocado passes examine (counter
`avocado_candidates`, summed over the passes): components holding a
voxel whose DBF passes soma_detection_threshold / 2.5, each a crop, six
2-D wall fills, a ray cast and a 3-D fill."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "avocado_candidates")

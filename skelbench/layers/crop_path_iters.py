"""Path-loop iterations a chunk's crop engine runs, summed over its lane
sets (counter `crop_path_iterations`)."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "crop_path_iterations")

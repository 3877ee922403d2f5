"""Labels a chunk hands the crop engine (counter `crop_engine_jobs`)."""

from layers._per_chunk import counter


def read(rec):
    return counter(rec, "crop_engine_jobs")

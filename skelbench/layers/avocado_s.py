"""Seconds a chunk spends in avocado protection: its passes (phases
`avocado_pass`) and the EDTs around them (phases `avocado_edt`, the
first EDT of the host stages among them)."""

from layers._per_chunk import phases


def read(rec):
    return phases(rec, ("avocado_pass", "avocado_edt"))

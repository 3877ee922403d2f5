"""Window totals over the window's chunks."""


def phases(rec, names):
    got = [rec["phases"][n] for n in names if n in rec["phases"]]
    if not got or not rec["chunks"]:
        return None
    return sum(got) / rec["chunks"]


def counter(rec, name):
    if name not in rec["counters"] or not rec["chunks"]:
        return None
    return rec["counters"][name] / rec["chunks"]

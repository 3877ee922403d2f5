"""Share of the profiled chunk in which no kernel, copy or memset ran on
the card."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

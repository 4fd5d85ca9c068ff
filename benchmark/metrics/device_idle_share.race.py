"""The card's idle share in the profiled stretch of a racing window:
1 - (union of its kernel, copy and set intervals) / the stretch's wall
time."""


def read(rec):
    if rec.get("kind") != "race" or rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]

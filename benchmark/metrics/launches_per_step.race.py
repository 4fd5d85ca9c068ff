"""Device kernel launches a racing step in the profiled stretch (copies
and sets not counted). K1 is one of them, named by CUPTI."""


def read(rec):
    if rec.get("kind") != "race" or not rec["steps"] or not rec["launches"]:
        return None
    return rec["launches"] / rec["steps"]

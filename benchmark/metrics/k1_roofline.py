"""K1's share of its roofline, in %: the least time the card could take
for a step's scans (``benchmark/roofline.py``, counted from the inputs),
over K1's device time a step in the profile, found by its kernel name."""


def read(rec):
    if rec.get("kind") != "race" or rec["k1_s"] <= 0:
        return None
    return 100.0 * rec["k1_bound_s"] / (rec["k1_s"] / rec["steps"])

"""Seconds a shape spends in the denoising stages on the graph: the
solver's own stage laps ``hr`` and, in the 3-stage model, ``feature``,
over the items the traced run times unprofiled, per shape."""


def read(t):
    laps = [lap for lap in t["laps"] if "hr" in lap]
    if t["kind"] != "gen" or not laps:
        return None
    total = sum(lap["hr"] + lap.get("feature", 0.0) for lap in laps)
    return total / (len(laps) * t["shapes"] / t["items"])

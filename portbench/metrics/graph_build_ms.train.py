"""Milliseconds a step spends building the batch's octree and dual graph:
the train step's own lap ``graph`` (``timed=True``), averaged over the
steps the traced run times unprofiled."""


def read(t):
    laps = [lap["graph"] for lap in t["laps"] if "graph" in lap]
    if t["kind"] != "train" or not laps:
        return None
    return 1e3 * sum(laps) / len(laps)

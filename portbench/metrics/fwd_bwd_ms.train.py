"""Milliseconds a step spends in the loss's forward and backward: the
train step's own lap ``forward_backward`` (``timed=True``), averaged over
the steps the traced run times unprofiled."""


def read(t):
    laps = [lap["forward_backward"] for lap in t["laps"]
            if "forward_backward" in lap]
    if t["kind"] != "train" or not laps:
        return None
    return 1e3 * sum(laps) / len(laps)

"""Shapes trained (batch x steps completed) over the whole window, which
ends at the first step completed at or after ``--seconds``."""


def read(run):
    if run["kind"] != "train" or run["window_s"] <= 0.0:
        return None
    return run["shapes"] / run["window_s"]

"""The whole window over the shapes it completed (the window starts at
the first timed shape and ends at the first completion at or after
``--seconds``)."""


def read(run):
    if run["kind"] != "gen" or not run["shapes"]:
        return None
    return run["window_s"] / run["shapes"]

"""Device operations (kernels, copies, sets) in the trace per generated
shape: an exact count of what the host dispatches."""


def read(t):
    if t["kind"] != "gen" or not t["shapes"]:
        return None
    return t["launches"] / t["shapes"]

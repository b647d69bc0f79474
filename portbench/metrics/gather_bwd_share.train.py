"""Share of the device time spent under autograd's backward of indexing
operations (``evaluate_function: Index*Backward*``): the gathers'
backward."""


def read(t):
    if t["kind"] != "train" or t["device_s"] <= 0.0:
        return None
    return 100.0 * t["index_bwd_s"] / t["device_s"]

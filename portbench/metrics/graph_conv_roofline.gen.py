"""Share of the graph convolutions' roofline: the summed least time of
every graph conv's work (forward; in training also the column buffer, the
input gradient and the weight gradient of its backward, and each forward a
checkpoint recomputes, counted as the call it is) over the device time of
the operations launched under those calls, by whatever implementation.
The bound comes from the frozen ``frozen/roofline.py``."""


def read(t):
    if t["kind"] != "gen" or t["conv_device_s"] <= 0.0:
        return None
    return 100.0 * t["conv_bound_s"] / t["conv_device_s"]

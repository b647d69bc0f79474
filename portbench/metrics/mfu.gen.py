"""Model FLOPs of a shape (by formula from module shapes over the
profiled items; a trained module's forward counts 3 times, no recomputed
forward counts) over the wall of an item timed unprofiled, times the peak
rate of the configuration's compute dtype."""


def read(t):
    if t["kind"] != "gen" or not t["model_flops"] or t["plain_s"] <= 0.0:
        return None
    flops = t["model_flops"] / t["items"]
    return 100.0 * flops / (t["plain_s"] / t["plain_items"] * t["peak_flops"])

"""Share of an item's wall, timed unprofiled, in which no operation ran
on the device: 1 - (union of the device's busy intervals per profiled
item) / (wall per item timed unprofiled)."""


def read(t):
    if t["kind"] != "gen" or t["plain_s"] <= 0.0 or not t["items"]:
        return None
    busy = t["busy_s"] / t["items"]
    return 100.0 * (1.0 - busy / (t["plain_s"] / t["plain_items"]))

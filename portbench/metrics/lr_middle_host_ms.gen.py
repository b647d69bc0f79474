"""Host milliseconds an hr denoising step spends in the lr U-Net's body as
the hr U-Net's middle: the program's span ``octf.unet.lr_middle`` (one an
hr call), summed over the items the traced run times unprofiled with the
program's tracing on, over its count.  None where the program has no such
span."""


def read(t):
    laps = [lap for lap in t["laps"] if lap.get("lr_middle_calls")]
    if t["kind"] != "gen" or not laps:
        return None
    return 1e3 * sum(lap["lr_middle_host_s"] for lap in laps) / sum(
        lap["lr_middle_calls"] for lap in laps)

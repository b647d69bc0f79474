"""Seconds from the process's start to the first timed item: imports,
reaching the card, the models and their seeded weights on the device, the
cell's inputs, and the warm-up (a training cell's three checked steps)."""


def read(run):
    return run["setup_s"]

"""Continuous capacity-overflow monitoring for the training loop (port of
``octfusion_tpu/utils/overflow.py``).

Every train step reports the static-capacity overflow flag of its octree
and graph in its loss dict.  Checking it only on print steps would let
the other ``print_freq - 1`` steps train on truncated graphs unseen, so
this monitor keeps a running ``torch.maximum`` of the flag on the flag's
device (no host sync per step) and raises at the next synchronisation
point (print time or shutdown).
"""

from __future__ import annotations

import torch


class OverflowMonitor:
    """Accumulates the per-step overflow flag; ``check()`` raises if any
    step since construction overflowed.  ``update`` never synchronises:
    the running max stays a device scalar until ``check`` reads it."""

    MESSAGE = (
        "octree/graph capacity overflow during training: nodes or edges "
        "were dropped, the step is wrong.  Raise capacity.finest_cap / "
        "capacity.edge_factor in the config (see octree/octree.py "
        "overflow contract)."
    )

    def __init__(self):
        self._acc = None

    def update(self, loss_dict) -> None:
        flag = loss_dict.get("overflow")
        if flag is None:
            return
        flag = torch.as_tensor(flag)
        self._acc = flag if self._acc is None else torch.maximum(self._acc,
                                                                 flag)

    def check(self) -> None:
        """Read the accumulator on the host and raise on any overflow so
        far."""
        if self._acc is not None and float(self._acc) > 0:
            raise RuntimeError(self.MESSAGE)

"""Console + file + TensorBoard logging (copy of
``octfusion_tpu/utils/visualizer.py``; the reference's
``utils/visualizer.py``).  TensorBoard is written when
``torch.utils.tensorboard`` imports.  A disabled visualizer (the ranks
other than the main one of a data-parallel run) prints and writes
nothing."""

from __future__ import annotations

import os
import time
from typing import Dict


class Visualizer:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.writer = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.log_file = os.path.join(log_dir, "loss_log.txt")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(os.path.join(log_dir, "tensorboard"))
        except ImportError:
            self.writer = None

    def print_current_errors(self, step: int, errors: Dict, t: float):
        if not self.enabled:
            return
        msg = f"[step {step}] t/it: {t:.3f}s " + " ".join(
            f"{k}: {float(v):.6f}" for k, v in errors.items()
        )
        print(msg, flush=True)
        with open(self.log_file, "a") as fh:
            fh.write(f"{time.strftime('%c')} {msg}\n")
        if self.writer is not None:
            for k, v in errors.items():
                self.writer.add_scalar(f"losses/{k}", float(v), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()

"""Checkpoints as ``torch.save`` files, with the rotation and auto-resume
contract of ``octfusion_tpu/utils/ckpt.py``.

Layout: ``<ckpt_dir>/steps-<N>.pth`` plus a ``steps-latest`` symlink to the
newest save; the newest ``ckpt_num`` step files are kept.  A save goes
through a temporary file and ``os.replace``, so a crash never leaves a
half-written ``steps-<N>.pth``; a temporary file left by a killed save is
swept by the next save or rotation.  The tree is whatever the caller
saves: for the diffusion model the reference's own layout (``df_unet_lr``,
``ema_df_unet_hr``, ... state dicts; ``utils/params.union_checkpoint``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_STEP = re.compile(r"steps-(\d+)\.pth")
_LATEST = "steps-latest"


def _steps(ckpt_dir: str):
    """-> [(step, file name)] of the step files in ``ckpt_dir``, oldest
    first."""
    entries = []
    for name in os.listdir(ckpt_dir):
        m = _STEP.fullmatch(name)
        if m:
            entries.append((int(m.group(1)), name))
    return sorted(entries)


def _clear_stale_tmp(ckpt_dir: str) -> None:
    """Remove temporary files left by killed saves.  This process is the
    run directory's single writer, so no save is in flight."""
    for name in os.listdir(ckpt_dir):
        if name.startswith("steps-") and name.endswith(".tmp"):
            os.remove(os.path.join(ckpt_dir, name))


def save(ckpt_dir: str, tree: Any, step: int, ckpt_num: int = 5) -> str:
    """Write ``tree`` to ``<ckpt_dir>/steps-<step>.pth``, point
    ``steps-latest`` at it and keep the newest ``ckpt_num`` step files;
    returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_dir = os.path.abspath(ckpt_dir)
    _clear_stale_tmp(ckpt_dir)
    path = os.path.join(ckpt_dir, f"steps-{step}.pth")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    lpath = os.path.join(ckpt_dir, _LATEST)
    if os.path.lexists(lpath):
        os.remove(lpath)
    os.symlink(path, lpath)
    rotate(ckpt_dir, ckpt_num)
    return path


def rotate(ckpt_dir: str, ckpt_num: int) -> None:
    """Keep only the newest ``ckpt_num`` step files (all of them when
    ``ckpt_num <= 0``), and sweep stale temporary files."""
    _clear_stale_tmp(ckpt_dir)
    entries = _steps(ckpt_dir)
    for _, name in entries[:-ckpt_num] if ckpt_num > 0 else []:
        os.remove(os.path.join(ckpt_dir, name))


def restore(path: str) -> Any:
    """The saved tree with every tensor on the host (the caller places
    them).  Only tensors and plain containers are unpickled."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def latest_path(ckpt_dir: str) -> Optional[str]:
    """Auto-resume: ``steps-latest`` if it exists, else the step file with
    the largest step, else None."""
    p = os.path.join(ckpt_dir, _LATEST)
    if os.path.exists(p):
        return p
    if not os.path.isdir(ckpt_dir):
        return None
    entries = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, entries[-1][1]) if entries else None

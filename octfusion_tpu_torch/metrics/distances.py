"""Point-cloud distances: Chamfer and approximate EMD, and their all-pairs
matrices (port of ``octfusion_tpu/metrics/distances.py``).

* ``chamfer`` — on a CUDA tensor the hand-written kernel K4
  (``ops/chamfer_cuda.chamfer``), on a CPU tensor its plain version;
* ``emd_approx`` — the auction-style approximate matching of the
  reference's ``approxmatch.cu``, 9 rounds of sharpening soft assignment
  with remaining-mass multipliers, as dense [B, N, M] tensor ops in plain
  PyTorch (the JAX package computes it outside Pallas too);
* ``pairwise_cd_emd`` — the [S, R] matrices over two cloud sets, in the
  JAX package's [row_block x batch] tiles of pairs: one K4 launch and one
  batched auction per tile; with ``shard_devices`` each tile's row block
  is split over several devices.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import chamfer_cuda
from ..ops.chamfer_cuda import pairwise_sqdist


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """Bidirectional squared Chamfer terms for a batch:
    a [B, N, 3], b [B, M, 3] float32 -> (dl [B, N], dr [B, M]).  A CUDA
    tensor launches K4 (or raises); a CPU tensor takes the plain version."""
    if a.is_cuda:
        return chamfer_cuda.chamfer(a, b)
    return chamfer_cuda.chamfer_plain(a, b)


def emd_approx(a: torch.Tensor, b: torch.Tensor, rounds: int = 9,
               store_dtype=torch.float32) -> torch.Tensor:
    """Auction-style approximate EMD matching cost, batched.

    a [B, N, 3], b [B, M, 3] -> [B] mean matched distance (float32), with
    the reference's exact level schedule (``approxmatch.cu:24-28``):
    j = 7..-1, level = -4^j (the last level is -0.25), weights =
    exp(level * d^2) scaled by the remaining row / column mass, normalised
    twice and accumulated into a soft match; the rows start with m/n of
    mass.

    ``store_dtype`` is the element type of the two [B, N, M] matrices that
    live across rounds (d^2 and the match); ``torch.bfloat16`` halves
    their bytes.  Every reduction and the remaining-mass carries stay
    float32, and the weights are recomputed from d^2 in float32 each
    round."""
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    f32 = dict(dtype=torch.float32, device=a.device)
    d2 = pairwise_sqdist(a, b).to(store_dtype)
    match = torch.zeros_like(d2)
    remain_r = torch.full((bsz, n), m / n, **f32)
    remain_c = torch.ones((bsz, m), **f32)
    for j in range(rounds - 2, -2, -1):
        level = -(4.0**j)
        w = d2.to(torch.float32) * level
        w.exp_()
        w.mul_(remain_r[:, :, None])
        # normalise columns by demand, rows by supply
        col = w.sum(1, keepdim=True)
        w.mul_(remain_c[:, None, :] / col.clamp_min(1e-9))
        row = w.sum(2, keepdim=True)
        w.mul_((remain_r[:, :, None] / row.clamp_min(1e-9)).clamp_max(1.0))
        match.add_(w)   # in float32, rounded once to store_dtype
        remain_r = (remain_r - w.sum(2)).clamp_min(0.0)
        remain_c = (remain_c - w.sum(1)).clamp_min(0.0)
        del w   # freed before the next round allocates its weights
    cost = (match.to(torch.float32) * d2.to(torch.float32).sqrt()).sum((1, 2))
    return cost / m


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat the last cloud up to ``n`` clouds."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand((n - x.shape[0],) + x.shape[1:])], 0)


def _tile(rows: torch.Tensor, cols: torch.Tensor, emd: bool, store_dtype):
    """Every (row, col) pair of one [rb x cb] tile -> (cd [rb, cb],
    emd [rb, cb]): one Chamfer call (one K4 launch on the card) and one
    batched auction over the rb * cb pairs."""
    rb, cb = rows.shape[0], cols.shape[0]
    a = rows[:, None].expand((rb, cb) + rows.shape[1:]).reshape(
        (rb * cb,) + rows.shape[1:])
    b = cols[None].expand((rb, cb) + cols.shape[1:]).reshape(
        (rb * cb,) + cols.shape[1:])
    dl, dr = chamfer(a, b)
    cdv = dl.mean(-1) + dr.mean(-1)
    emv = (emd_approx(a, b, store_dtype=store_dtype) if emd
           else torch.zeros_like(cdv))
    return cdv.reshape(rb, cb), emv.reshape(rb, cb)


def pairwise_cd_emd(sample: torch.Tensor, ref: torch.Tensor, batch: int = 16,
                    emd: bool = True, row_block: int = 4,
                    emd_store_dtype=torch.float32, progress: str = None,
                    shard_devices=None):
    """All-pairs Chamfer (+EMD) matrices between two point-cloud sets
    (``metrics/evaluation_metrics.py:111-154`` of the reference): sample
    [S, P, 3], ref [R, P', 3] float32 on one device -> (cd [S, R],
    emd [S, R]) numpy float32; ``emd`` is all zero unless asked for.

    The pair grid is cut into [row_block x batch] tiles, the last row and
    column block padded by repeating their last cloud and the padding
    cropped from the result, as in the JAX package.  Peak device memory is
    a few [row_block * batch, P, P'] float32 matrices (the auction holds
    d^2, the weights and the match).

    ``shard_devices``: a list of devices (or ``"auto"``: every visible
    CUDA device, or none when there is one) to split each tile's rows
    over, as the JAX package's sharded loop does: every device computes
    ``row_block`` rows of a [len(devices) * row_block x batch] tile, the
    column block copied to each, with no collective.  None is the
    sample's device alone.  Each device runs the same per-pair programs
    on the same [row_block x batch] tile shape, so the matrices do not
    depend on the number of devices, bit for bit."""
    if shard_devices == "auto":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        shard_devices = ([torch.device("cuda", i) for i in range(n)]
                         if n > 1 else None)
    devices = ([torch.device(d) for d in shard_devices]
               if shard_devices is not None else [sample.device])
    rb = len(devices) * row_block
    s, r = sample.shape[0], ref.shape[0]
    cd = np.zeros((s, r), np.float32)
    em = np.zeros((s, r), np.float32)
    beat = _heartbeat(progress)
    for i0 in range(0, s, rb):
        i1 = min(i0 + rb, s)
        rows = _pad_to(sample[i0:i1], rb)
        parts = [rows[k * row_block:(k + 1) * row_block].to(dev)
                 for k, dev in enumerate(devices)]
        for j0 in range(0, r, batch):
            j1 = min(j0 + batch, r)
            cols = _pad_to(ref[j0:j1], batch)
            # every device's kernels are launched before any result is
            # read back, so the devices work at once
            tiles = [_tile(part, cols.to(dev), emd, emd_store_dtype)
                     for part, dev in zip(parts, devices)]
            cdv = torch.cat([t[0].cpu() for t in tiles]).numpy()
            emv = torch.cat([t[1].cpu() for t in tiles]).numpy()
            cd[i0:i1, j0:j1] = cdv[: i1 - i0, : j1 - j0]
            em[i0:i1, j0:j1] = emv[: i1 - i0, : j1 - j0]
        beat(i1 * r, s * r)
    return cd, em


def _heartbeat(progress):
    """Time-throttled stderr progress line — an eval tile grid runs for
    tens of minutes with no output otherwise, which is indistinguishable
    from a wedged device transport."""
    state = {"last": time.time(), "start": time.time()}

    def beat(done, total):
        if progress and time.time() - state["last"] > 30:
            state["last"] = time.time()
            rate = done / max(state["last"] - state["start"], 1e-9)
            sys.stderr.write(
                f"[pairwise {progress}] {done}/{total} pairs "
                f"({100 * done / total:.0f}%, {rate:.0f} pairs/s, "
                f"eta {(total - done) / max(rate, 1e-9):.0f}s)\n")
            sys.stderr.flush()

    return beat

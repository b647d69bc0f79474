"""Generation-quality metrics: 1-NNA, COV, MMD, diversity (port of
``octfusion_tpu/metrics/evaluation.py``; the reference's
``metrics/evaluation_metrics.py:204-246`` and ``metrics/diversity.py``).

The pairwise CD / EMD matrices are computed on the device
(``distances.pairwise_cd_emd``); the metric arithmetic over them stays
numpy on the host, as in the JAX package."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.device import resolve_device
from .distances import pairwise_cd_emd


def compute_cov_mmd(m_sr: np.ndarray) -> Dict[str, float]:
    """COV / MMD from the sample-x-reference distance matrix
    (`evaluation_metrics.py:204-218`)."""
    # MMD: for each reference, its closest sample distance (averaged)
    mmd = float(m_sr.min(axis=0).mean())
    # COV: fraction of references that are someone's nearest neighbour
    nearest = m_sr.argmin(axis=1)
    cov = float(len(np.unique(nearest)) / m_sr.shape[1])
    return {"cov": cov, "mmd": mmd}


def compute_1_nna(
    m_ss: np.ndarray, m_rr: np.ndarray, m_sr: np.ndarray
) -> float:
    """1-nearest-neighbour two-sample accuracy
    (`evaluation_metrics.py:221-246`): 0.5 is ideal (indistinguishable)."""
    s = m_ss.shape[0]
    r = m_rr.shape[0]
    big = np.finfo(np.float32).max
    m_ss = m_ss + np.eye(s, dtype=np.float32) * big
    m_rr = m_rr + np.eye(r, dtype=np.float32) * big
    # label 1 = sample, 0 = reference
    # for each sample: nearest among (other samples, references)
    s_nn_same = m_ss.min(axis=1)
    s_nn_other = m_sr.min(axis=1)
    s_correct = (s_nn_same < s_nn_other).astype(np.float32)
    r_nn_same = m_rr.min(axis=1)
    r_nn_other = m_sr.min(axis=0)
    r_correct = (r_nn_same < r_nn_other).astype(np.float32)
    return float((s_correct.sum() + r_correct.sum()) / (s + r))


def evaluate_point_sets(sample_pts, ref_pts, batch: int = 16,
                        emd: bool = True, emd_bf16: bool = False,
                        device="cuda") -> Dict[str, float]:
    """Full eval: sample / ref [S / R, P, 3] -> 1-NNA + COV / MMD for CD
    and EMD (the reference's ``metrics/1-NNA.py`` + ``metrics/cov_mmd.py``
    scripts), the three pairwise matrices computed on ``device``: the card
    unless the caller asks for the CPU (without a card the default
    raises).

    ``emd_bf16`` stores the EMD auction's cross-round matrices in bfloat16
    (half their bytes; the costs stay within 2.5e-3 relative of float32);
    the default is float32, like the reference's auction."""
    dev = resolve_device(device)
    store = torch.bfloat16 if emd_bf16 else torch.float32
    sp = torch.as_tensor(sample_pts, dtype=torch.float32, device=dev)
    rp = torch.as_tensor(ref_pts, dtype=torch.float32, device=dev)
    kw = dict(emd_store_dtype=store)
    cd_sr, emd_sr = pairwise_cd_emd(sp, rp, batch, emd, progress="s-r", **kw)
    cd_ss, emd_ss = pairwise_cd_emd(sp, sp, batch, emd, progress="s-s", **kw)
    cd_rr, emd_rr = pairwise_cd_emd(rp, rp, batch, emd, progress="r-r", **kw)
    out = {}
    out["1nna_cd"] = compute_1_nna(cd_ss, cd_rr, cd_sr)
    cm = compute_cov_mmd(cd_sr)
    out["cov_cd"] = cm["cov"]
    out["mmd_cd"] = cm["mmd"]
    if emd:
        out["1nna_emd"] = compute_1_nna(emd_ss, emd_rr, emd_sr)
        cm = compute_cov_mmd(emd_sr)
        out["cov_emd"] = cm["cov"]
        out["mmd_emd"] = cm["mmd"]
    return out


def diversity_topk(m_ss: np.ndarray, k: int = 5) -> float:
    """Mean distance of each sample to its k nearest other samples
    (`metrics/diversity.py`)."""
    s = m_ss.shape[0]
    m = m_ss + np.eye(s, dtype=np.float32) * np.finfo(np.float32).max
    idx = np.argsort(m, axis=1)[:, :k]
    return float(np.take_along_axis(m, idx, 1).mean())

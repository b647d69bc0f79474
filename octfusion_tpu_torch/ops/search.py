"""Binary search over (batch, key) pairs (port of
``octfusion_tpu/ops/search.py``).

The JAX package searches pairs of int32 arrays lexicographically, because
it runs without 64-bit integers.  PyTorch indexes in int64, so the port
folds each pair into one int64 key ``hi * 2^32 + lo`` (for int32 ``lo``
this keeps the lexicographic order) and calls ``torch.searchsorted``,
which returns the same left-insertion index.
"""

from __future__ import annotations

import torch


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key per (hi, lo) pair of int32-range values, ordered as
    the pairs are ordered lexicographically."""
    return hi.to(torch.int64) * 2**32 + lo.to(torch.int64)


def searchsorted_pair(hi: torch.Tensor, lo: torch.Tensor, qhi: torch.Tensor,
                      qlo: torch.Tensor) -> torch.Tensor:
    """Left-insertion index of each query (qhi, qlo) into the
    lexicographically ascending pair sequence (hi, lo); all values in the
    int32 range.  Returns int64 indices in [0, len(hi)]."""
    return torch.searchsorted(pair_key(hi, lo).contiguous(),
                              pair_key(qhi, qlo).contiguous(), side="left")

"""Morton (Z-order) key math (port of ``octfusion_tpu/octree/morton.py``).

Bit of x at level i lands at position 3i+2, y at 3i+1, z at 3i.  Keys fit in
30 bits (depth <= 10); the port computes in int64 and keeps the reference's
int32 sentinel value for padded slots, so keys compare value for value.
"""

from __future__ import annotations

import torch

MAX_DEPTH = 10
# Sentinel for padded (invalid) key slots: sorts after every valid key.
INVALID_KEY = 2**31 - 1
_U32 = 0xFFFFFFFF


def _part_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so bit i moves to bit 3*i."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact_bits(code: torch.Tensor) -> torch.Tensor:
    """Inverse of _part_bits."""
    v = code & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def xyz2key(x, y, z, depth: int) -> torch.Tensor:
    """Interleave integer coordinates into a Morton key at ``depth``."""
    assert depth <= MAX_DEPTH
    return (_part_bits(x) << 2) | (_part_bits(y) << 1) | _part_bits(z)


def key2xyz(key: torch.Tensor, depth: int):
    """Decode a Morton key into (x, y, z) int64 coordinates.  Like the
    reference, the sentinel key decodes to garbage coordinates (up to
    1023): callers mask or clamp them."""
    assert depth <= MAX_DEPTH
    k = key.to(torch.int64) & _U32
    return _compact_bits(k >> 2), _compact_bits(k >> 1), _compact_bits(k)

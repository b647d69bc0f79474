"""Interval arithmetic of the traced run: the device's busy time as the
union of its operations' intervals (operations of several streams may
overlap, so their durations are not summed), the idle gaps between them,
and the innermost host span open at a point of a thread.

This is the arithmetic of the program's ``profile_step.py`` (idle share
``1 - device / wall``), taken over the union of device intervals instead
of the sum of kernel durations, and frozen here with the benchmark.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple


def clip(intervals: Sequence[Tuple[int, int]], lo: int, hi: int):
    """The parts of ``intervals`` inside [lo, hi)."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint union of ``intervals`` (half-open)."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in merged(intervals))


def gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for a, b in merged(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


class SpanIndex:
    """Host spans of one thread, properly nested as ``record_function``
    scopes are, for the query "which span is innermost at time t"."""

    def __init__(self, spans: Sequence[Tuple[int, int, object]]):
        # (start, end, key) sorted by start, longer first on ties, so a
        # parent precedes its children
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        # parent of each span: the innermost earlier span that contains it
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t: int) -> Optional[int]:
        """Index (into ``spans``) of the innermost span with start <= t <
        end, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            a, b, _ = self.spans[i]
            if a <= t < b:
                return i
            i = self.parent[i]
        return None

    def key(self, i: Optional[int]):
        return None if i is None else self.spans[i][2]


def by_thread(spans: Sequence[Tuple[int, int, int, object]]
              ) -> Dict[int, SpanIndex]:
    """(thread, start, end, key) -> one :class:`SpanIndex` per thread."""
    groups: Dict[int, list] = {}
    for th, a, b, key in spans:
        groups.setdefault(th, []).append((a, b, key))
    return {th: SpanIndex(v) for th, v in groups.items()}

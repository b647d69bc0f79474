"""The tiny stand-in of each configuration added after ``pbtest_util``'s
table: ``make_root`` swaps every configuration of ``BENCHMARK.json`` for
the stand-in this table names."""

import pbtest_util

pbtest_util.TINY.setdefault("snet-cond", "tiny-cond")

"""The packed graph conv K5 at five shapes, on one NVIDIA GPU: the
compiler's register and shared-memory report for ``graph_conv.cu``, then
K5 against its plain version and against K1 (max abs errors, mean ms of
20 launches after 3 warm-up), on the levels 4-6 of a seeded random
sampling graph at the default configuration's caps.

Usage, from the repository root: ``python scripts/k5_shapes.py``.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from octfusion_tpu_torch.octree.dual_graph import build_dual_graph  # noqa: E402
from octfusion_tpu_torch.octree.octree import OctreeSpec  # noqa: E402
from octfusion_tpu_torch.octree.split_codec import split2octree_small  # noqa: E402
from octfusion_tpu_torch.ops import cuda_lib  # noqa: E402
from octfusion_tpu_torch.ops import graph_conv_cuda as k  # noqa: E402

SHAPES = [(4, 515, 512), (6, 131, 128), (6, 6, 128), (5, 259, 256),
          (6, 128, 3)]   # (level, C, C')


def graph(device, seed=7, depth=8, full_depth=4):
    """The depth-6 graph of a random split grid sparse enough for the
    default caps (finest_cap 131072, decay 4)."""
    rng = np.random.RandomState(seed)
    s = 2**full_depth
    split = torch.tensor(
        np.where(rng.rand(1, s, s, s, 8) < 0.012, 1.0, -1.0).astype(np.float32),
        device=device)
    spec = OctreeSpec.create(depth, full_depth, 1,
                             finest_cap_per_sample=131072, decay=4.0)
    return build_dual_graph(split2octree_small(split, spec), 9,
                            up_to=full_depth + 2)


def mean_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k5_shapes: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                              "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "k.so"), k.SOURCE],
                             capture_output=True, text=True)
    print(res.returncode, res.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = graph(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for d, c, cout in SHAPES:
        lvl = g.level(d)
        csr = lvl.csr()
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        got = k.graph_conv_packed(x, w, *csr)
        ref = k.graph_conv_packed_plain(x, w, lvl.edge_row, lvl.edge_col,
                                        lvl.edge_dir, lvl.edge_scale)
        k1 = k.graph_conv(x, w, *csr)
        torch.cuda.synchronize()
        print(f"d={d} C={c} C'={cout} k5_err={(got - ref).abs().max():.3e} "
              f"k1_err={(k1 - ref).abs().max():.3e} "
              f"ref_max={ref.abs().max():.3e} "
              f"k5_ms={mean_ms(lambda: k.graph_conv_packed(x, w, *csr)):.4f} "
              f"k1_ms={mean_ms(lambda: k.graph_conv(x, w, *csr)):.4f}",
              flush=True)


if __name__ == "__main__":
    main()

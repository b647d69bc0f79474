"""The packed graph conv K5 at five shapes, on one NVIDIA GPU: the
compiler's register, shared-memory and spill report for ``graph_conv.cu``,
then K5 against its plain version and K1 on the same tensors (max abs
errors; median ms of 20 CUDA-event runs after 3 warm-up, and device ms
per call from a ``torch.profiler`` trace of 20 calls) on the levels
4-6 of a seeded random sampling graph at the default configuration's
caps, and, with ``--baseline DIR``, the K5 built from ``DIR``'s
``octfusion_tpu_torch/csrc/graph_conv.cu`` on the same tensors.  Then the
sums over the shapes.

Usage, from the repository root:
``python scripts/k5_shapes.py [--baseline DIR]``.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import cuda_ms, device_ms  # noqa: E402
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


def ptxas_report(keep=("gather_gemm", "graph_conv_col")):
    """Compile ``graph_conv.cu`` with ``-Xptxas -v`` and print the lines
    on registers, spills and errors of the kernels named in ``keep``."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                              "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "k.so"), k.SOURCE],
                             capture_output=True, text=True)
    lines, name = [], ""
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln:
            name = ln
        elif "error" in ln or (any(s in name for s in keep)
                               and ("registers" in ln or "spill" in ln)):
            lines.append(f"{name.split()[-1] if name else ''} {ln.strip()}")
    print(res.returncode, "\n".join(lines), flush=True)


def packed(lib, dev):
    """K5 from the library ``lib`` (None: the wrapper's own)."""
    if lib is None:
        return k.graph_conv_packed

    def run(x, w, ptr, idx, scale):
        out = torch.empty((x.shape[0], w.shape[1]), device=dev)
        cuda_lib.call(lib, "graph_conv_fwd_packed", dev, x.data_ptr(),
                      w.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), x.shape[0],
                      x.shape[1], w.shape[1])
        return out

    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a checkout whose graph_conv.cu is "
                    "timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_shapes: no CUDA device")
    ptxas_report()
    base = None
    if args.baseline:
        base = packed(cuda_lib.load(os.path.join(
            args.baseline, "octfusion_tpu_torch", "csrc", "graph_conv.cu"),
            k._SIGNATURES), torch.device("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = graph(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {}
    for d, c, cout in SHAPES:
        lvl = g.level(d)
        csr = lvl.csr()
        x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
        w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
        ref = k.graph_conv_packed_plain(x, w, lvl.edge_row, lvl.edge_col,
                                        lvl.edge_dir, lvl.edge_scale)
        got = k.graph_conv_packed(x, w, *csr)
        k1 = k.graph_conv(x, w, *csr)
        torch.cuda.synchronize()
        line = {"k5_err": (got - ref).abs().max().item(),
                "k1_err": (k1 - ref).abs().max().item(),
                "k5_ms": cuda_ms(lambda: k.graph_conv_packed(x, w, *csr)),
                "k1_ms": cuda_ms(lambda: k.graph_conv(x, w, *csr)),
                "k5_dev_ms": device_ms(lambda: k.graph_conv_packed(x, w,
                                                                   *csr)),
                "k1_dev_ms": device_ms(lambda: k.graph_conv(x, w, *csr))}
        if base is not None:
            line["base_err"] = (base(x, w, *csr) - ref).abs().max().item()
            line["base_ms"] = cuda_ms(lambda: base(x, w, *csr))
            line["base_dev_ms"] = device_ms(lambda: base(x, w, *csr))
        for key, v in line.items():
            if key.endswith("ms"):
                sums[key] = sums.get(key, 0.0) + v
        print(f"d={d} G={lvl.g_cap} C={c} C'={cout} " + " ".join(
            f"{key}={v:.3e}" if "err" in key else f"{key}={v:.4f}"
            for key, v in line.items()), flush=True)
    print("sums " + " ".join(f"{key}={v:.4f}" for key, v in sums.items()),
          flush=True)


if __name__ == "__main__":
    main()

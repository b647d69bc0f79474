"""The graph conv's gather-GEMM kernels K1 (forward) and K3 (input
gradient), and K2 (the column buffer) beside K3, at eight shapes of the
sampling graph's levels 4-6 and on the synthetic edge-case level of
``tests/test_torch_port_csr_cases.py``, on one NVIDIA GPU: the compiler's
register, shared-memory and spill report for ``graph_conv.cu``, then each
kernel against its plain version (max abs error) and its time (CUDA
events, median of 20 after 3 warm-up) beside the plain version's, the
GEMM alone on the materialised column buffer (``col @ W``; K3 ``dout @
W^T``; none for K2), and, with ``--baseline DIR``, the same entry points
built from ``DIR``'s ``octfusion_tpu_torch/csrc/graph_conv.cu`` on the
same tensors.  ``ms`` is the median of 20 CUDA-event-timed calls, host
launch overhead included; ``dev_ms`` the kernel's device time per call
from a ``torch.profiler`` trace of 20 calls.  With ``--train``, the hr
train step's shapes instead (``chip_smoke.py``'s phase 6).  Then the sums
over the shapes.

Usage, from the repository root:
``python scripts/k1_shapes.py [--baseline DIR] [--train]``.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import k5_shapes  # noqa: E402
import test_torch_port_csr_cases as csr_cases  # noqa: E402
from chip_smoke import cuda_ms, training_setup  # noqa: E402
from octfusion_tpu_torch.ops import cuda_lib  # noqa: E402
from octfusion_tpu_torch.ops import graph_conv_cuda as k  # noqa: E402
from octfusion_tpu_torch.utils.device import use_fp32_math  # noqa: E402

SHAPES = [(4, 515, 512), (4, 516, 512), (4, 259, 512), (5, 259, 256),
          (5, 131, 256), (6, 131, 128), (6, 6, 128), (6, 128, 3)]
SYNTHETIC = [(515, 512), (31, 24)]    # (C, C') on the edge-case level


def graph(device, seed=7):
    """The depth-6 graph of a random split grid at the default caps, as
    ``scripts/k5_shapes.py`` builds it."""
    return k5_shapes.graph(device, seed)


def entry(lib, name, dev):
    """K1 / K2 / K3 from the library ``lib`` (None: the wrapper's own)."""
    if lib is None:
        return {"graph_conv_fwd": k.graph_conv,
                "graph_conv_col": lambda a, w, *csr: k.graph_conv_col(a, *csr),
                "graph_conv_bwd_dx": k.graph_conv_bwd_dx}[name]

    def col(a, w, ptr, idx, scale):
        out = torch.empty((a.shape[0], 7 * a.shape[1]), device=dev)
        cuda_lib.call(lib, name, dev, a.data_ptr(), ptr.data_ptr(),
                      idx.data_ptr(), scale.data_ptr(), out.data_ptr(),
                      a.shape[0], a.shape[1])
        return out

    if name == "graph_conv_col":
        return col

    def run(a, w, ptr, idx, scale):
        g = a.shape[0]
        c, cout = ((a.shape[1], w.shape[1]) if name == "graph_conv_fwd"
                   else (w.shape[0] // 7, a.shape[1]))
        out = torch.empty((g, cout if name == "graph_conv_fwd" else c),
                          device=dev)
        cuda_lib.call(lib, name, dev, a.data_ptr(), w.data_ptr(),
                      ptr.data_ptr(), idx.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), g, c, cout)
        return out

    return run


def run_case(lvl, where, c, cout, kernels, base, dev, gen, sums):
    """Times ``kernels`` (entry point names) on one (level, C, C') and
    adds each ``..._ms`` into ``sums``."""
    x = torch.randn(lvl.g_cap, c, device=dev, generator=gen)
    dout = torch.randn(lvl.g_cap, cout, device=dev, generator=gen)
    w = torch.randn(7 * c, cout, device=dev, generator=gen) / (7 * c) ** 0.5
    edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
    col = k.graph_conv_col_plain(x, *edges)
    runs = {
        "graph_conv_fwd": (x, lvl.csr(),
                           lambda: k.graph_conv_plain(x, w, *edges),
                           lambda: col @ w),
        "graph_conv_col": (x, lvl.csr(),
                           lambda: k.graph_conv_col_plain(x, *edges), None),
        "graph_conv_bwd_dx": (dout, lvl.csr_t(),
                              lambda: k.graph_conv_bwd_dx_plain(dout, w,
                                                                *edges),
                              lambda: dout @ w.t()),
    }
    for name in kernels:
        a, csr, plain, gemm = runs[name]
        new = entry(None, name, dev)
        ref = plain()
        got = new(a, w, *csr)
        torch.cuda.synchronize()
        line = {"err": (got - ref).abs().max().item(),
                "ms": cuda_ms(lambda: new(a, w, *csr)),
                "dev_ms": k5_shapes.device_ms(lambda: new(a, w, *csr)),
                "plain_ms": cuda_ms(plain)}
        if gemm is not None:
            line["gemm_ms"] = cuda_ms(gemm)
        if base is not None:
            old = entry(base, name, dev)
            line["base_err"] = (old(a, w, *csr) - ref).abs().max().item()
            line["base_ms"] = cuda_ms(lambda: old(a, w, *csr))
            line["base_dev_ms"] = k5_shapes.device_ms(
                lambda: old(a, w, *csr))
        tag = {"graph_conv_fwd": "k1", "graph_conv_col": "k2",
               "graph_conv_bwd_dx": "k3"}[name]
        for key, v in line.items():
            if key.endswith("ms"):
                sums[(tag, key)] = sums.get((tag, key), 0.0) + v
        print(f"{tag} {where} G={lvl.g_cap} C={c} C'={cout} " + " ".join(
            f"{key}={v:.3e}" if "err" in key else f"{key}={v:.4f}"
            for key, v in line.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a checkout whose graph_conv.cu is "
                    "timed beside this one")
    ap.add_argument("--train", action="store_true",
                    help="the hr train step's shapes instead (chip_smoke's "
                         "phase 6: K1 at every conv, K2 and K3 at the "
                         "differentiable ones)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_shapes: no CUDA device")
    k5_shapes.ptxas_report()
    base = None
    if args.baseline:
        base = cuda_lib.load(os.path.join(
            args.baseline, "octfusion_tpu_torch", "csrc", "graph_conv.cu"),
            k._SIGNATURES)
    use_fp32_math()
    dev = torch.device("cuda")
    all3 = ("graph_conv_fwd", "graph_conv_col", "graph_conv_bwd_dx")
    if args.train:
        *_, g_train, fwd_shapes, shapes = training_setup(0)
        cases = [(g_train.level(d), f"train d={d}", c, cout,
                  all3 if (d, c, cout) in shapes else all3[:1])
                 for d, c, cout in sorted(fwd_shapes)]
    else:
        g = graph(dev)
        cases = ([(g.level(d), f"d={d}", c, cout, all3)
                  for d, c, cout in SHAPES]
                 + [(csr_cases.synthetic_level(device=dev), "synthetic", c,
                     cout, all3) for c, cout in SYNTHETIC])
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {}
    for case in cases:
        run_case(*case, base, dev, gen, sums)
    print("sums " + " ".join(f"{t}_{key}={v:.4f}"
                             for (t, key), v in sums.items()), flush=True)


if __name__ == "__main__":
    main()

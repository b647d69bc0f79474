"""The Chamfer kernel K4 at the evaluation's shapes, on one NVIDIA GPU: the
compiler's register, shared-memory and spill report for ``chamfer.cu``
and the SASS opcode counts of its kernel; the issue rate of the 32-bit
minima on the card, which ``roofline.MINIMA_RATE`` assumes; then, at
N = M = 2048 with B = 16, 32 (the evaluation's launch: ``row_block`` 4 x
``--batch`` 8), 64 and 256 pairs, and on the ragged, near-duplicate, NaN
and non-finite cases: K4 against the plain version (max abs errors, NaN
and +inf where the plain version has them; disagreements are listed at
the end, and one of this tree's K4 makes the exit code 1), beside
``torch.cdist`` squared and both minima (a yardstick the port never
calls).  Each is timed as the median ms of 20 CUDA-event-timed calls and
as device ms per call from a ``torch.profiler`` trace of 20 calls (the
``dr`` fill kernel included), with the share by device time of K4's
bound (``roofline.bound_times``: the minima at ``MINIMA_RATE`` or the
products at the TF32 rate) and of the direct form's (8 FLOP per pair at
the fp32 rate).  With ``--baseline DIR``, the K4 built from ``DIR``'s
``octfusion_tpu_torch/csrc/chamfer.cu`` on the same tensors.  Then the
sums over the four evaluation batches.

Usage, from the repository root:
``python scripts/k4_shapes.py [--baseline DIR]``.
"""

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (TOL_CHAMFER, cdist_minima, cuda_ms,  # noqa: E402
                        device_ms)
from octfusion_tpu_torch.ops import chamfer_cuda as k4  # noqa: E402
from octfusion_tpu_torch.ops import cuda_lib, roofline  # noqa: E402

POINTS = 2048
CASES = [("eval", 16, POINTS, POINTS), ("eval", 32, POINTS, POINTS),
         ("eval", 64, POINTS, POINTS), ("eval", 256, POINTS, POINTS),
         ("ragged", 2, 700, 1100), ("near_duplicate", 16, POINTS, POINTS),
         ("nan", 4, POINTS, POINTS), ("non_finite", 4, POINTS, POINTS)]
KERNELS = ("chamfer_tc_kernel",)


def clouds(case, bsz, n, m, gen, dev):
    """Seeded clouds in the unit cube; ``nan`` puts a NaN coordinate in
    a[0, 2] and in b[1, 5], ``non_finite`` +inf in a[0, 3], 1e20 in
    a[1, 4], -inf in b[2, 6] and -1e20 in b[3, 9]."""
    a = torch.rand(bsz, n, 3, device=dev, generator=gen) - 0.5
    if case == "near_duplicate":
        b = a + 1e-3 * torch.randn(a.shape, device=dev, generator=gen)
    else:
        b = torch.rand(bsz, m, 3, device=dev, generator=gen) - 0.5
    if case == "nan":
        a[0, 2, 1] = float("nan")
        b[1, 5, 0] = float("nan")
    if case == "non_finite":
        a[0, 3, 2] = float("inf")
        a[1, 4, 0] = 1e20
        b[2, 6, 1] = -float("inf")
        b[3, 9, 2] = -1e20
    return a, b


def max_err(got, ref) -> float:
    """Largest |got - ref| over both outputs after checking them within
    ``TOL_CHAMFER``, NaN and +inf where ``ref`` has them, and no -0.0
    elsewhere."""
    err = 0.0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, equal_nan=True, **TOL_CHAMFER)
        if torch.signbit(g[~g.isnan()]).any():
            raise AssertionError("-0.0 in K4's output")
        err = max(err, (g - r).nan_to_num(0.0).abs().max().item())
    return err


def entry(lib, name):
    """``chamfer`` through the entry point ``name`` of ``lib``, with the
    wrapper's +inf fill; counts no launch."""
    def run(a, b):
        bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
        dl = torch.empty((bsz, n), device=a.device)
        dr = torch.full((bsz, m), float("inf"), device=a.device)
        cuda_lib.call(lib, name, a.device, a.data_ptr(), b.data_ptr(),
                      dl.data_ptr(), dr.data_ptr(), bsz, n, m)
        return dl, dr
    return run


def compiler_report(source=k4.SOURCE):
    """Compile ``source`` with ``-Xptxas -v``: print each kernel's
    registers, spills and errors, then its SASS opcode counts."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "k.so")
        res = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                              "-Xptxas", "-v", "-o", lib, source],
                             capture_output=True, text=True)
        name = ""
        for ln in res.stderr.splitlines():
            if "Compiling entry function" in ln:
                name = ln.split()[-1]
            elif "error" in ln or "registers" in ln or "spill" in ln:
                print(f"ptxas {name} {ln.strip()}", flush=True)
        print(f"nvcc exit {res.returncode}", flush=True)
        cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = next((k for k in KERNELS if k in ln), None)
            if name:
                counts[name] = collections.Counter()
        elif name:
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)", ln)
            if op:
                counts[name][op.group(1)] += 1
    for name, c in counts.items():
        print(f"sass {name}: {sum(c.values())} instructions; " + " ".join(
            f"{op}={n}" for op, n in c.most_common()), flush=True)


# 8 independent chains of 32-bit minima per thread, 32 per loop trip
RATE_SOURCE = r"""
template <int kThree>
__global__ void rate_kernel(int* out, long long* cycles, int iters) {
  int s[8];
  for (int k = 0; k < 8; ++k) s[k] = threadIdx.x * 8 + k + out[0];
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        s[k] = kThree ? __vimin3_s32(s[k], s[(k + 3) % 8], s[(k + 5) % 8])
                      : min(s[k], s[(k + 3) % 8]);
  __syncthreads();
  const long long t1 = clock64();
  int r = 0;
  for (int k = 0; k < 8; ++k) r ^= s[k];
  if (r == 12345) out[1] = r;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int rate(int three, int* out, long long* cycles, int blocks,
                    int iters) {
  if (three) rate_kernel<1><<<blocks, 1024>>>(out, cycles, iters);
  else rate_kernel<0><<<blocks, 1024>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
"""


def minima_rate():
    """Issue rate of the minima K4's loop is made of, in instructions per
    SM and clock (``clock64`` cycles of one 1024-thread block on each SM):
    the three-way minimum (VIMNMX3) that ``roofline.MINIMA_RATE`` counts,
    and the two-input one."""
    import ctypes

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rate.cu")
        lib = os.path.join(tmp, "rate.so")
        with open(src, "w") as fh:
            fh.write(RATE_SOURCE)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", lib,
                        src], check=True)
        fn = ctypes.CDLL(lib).rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    iters = 4096
    for three, name in ((1, "three-way (VIMNMX3)"), (0, "two-input")):
        for _ in range(2):
            if fn(three, out.data_ptr(), cycles.data_ptr(), sms, iters):
                raise RuntimeError("rate kernel launch failed")
        torch.cuda.synchronize()
        per_clock = 1024 * iters * 32 / cycles.double().mean().item()
        print(f"minima rate {name}: {per_clock:.1f} per SM and clock",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a checkout whose chamfer.cu is "
                    "timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_shapes: no CUDA device")
    compiler_report()
    minima_rate()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {"k4": k4.chamfer}
    if args.baseline:
        runs["base"] = entry(cuda_lib.load(os.path.join(
            args.baseline, "octfusion_tpu_torch", "csrc", "chamfer.cu"),
            {"chamfer_fwd": k4._SIGNATURES["chamfer_fwd"]}), "chamfer_fwd")
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = collections.Counter()
    failed = []
    for case, bsz, n, m in CASES:
        a, b = clouds(case, bsz, n, m, gen, dev)
        ref = k4.chamfer_plain(a, b)
        line = {}
        for key, fn in runs.items():
            try:
                line[f"{key}_err"] = max_err(fn(a, b), ref)
            except AssertionError as e:
                failed.append(f"{key} {case} B={bsz}: {e}")
                line[f"{key}_err"] = float("nan")
        cost = roofline.chamfer_cost(bsz, n, m)
        ops_ms, bytes_ms = roofline.bound_times("chamfer", *cost)
        bound = max(ops_ms, bytes_ms)
        bound_fp32 = max(roofline.times_ms(*cost))
        for key, fn in runs.items():
            line[f"{key}_ms"] = cuda_ms(lambda: fn(a, b))
            line[f"{key}_dev_ms"] = device_ms(lambda: fn(a, b))
            line[f"{key}_share"] = bound / line[f"{key}_dev_ms"]
            line[f"{key}_share_fp32"] = bound_fp32 / line[f"{key}_dev_ms"]
        line["plain_ms"] = cuda_ms(lambda: k4.chamfer_plain(a, b))
        line["cdist_ms"] = cuda_ms(lambda: cdist_minima(a, b))
        line["bound_ms"] = bound
        line["bound_fp32_ms"] = bound_fp32
        if case == "eval":
            sums.update({k: v for k, v in line.items()
                         if k.endswith("ms")})
        print(f"k4 {case} B={bsz} N={n} M={m} bound_by="
              f"{'operations' if ops_ms >= bytes_ms else 'bytes'} " +
              " ".join(f"{k}={v:.3e}" if "err" in k else f"{k}={v:.4f}"
                       for k, v in line.items()), flush=True)
        del a, b, ref
        torch.cuda.empty_cache()
    print("sums (eval B = 16, 32, 64, 256) " + " ".join(
        f"{k}={v:.4f}" for k, v in sums.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if failed:
        print("disagrees with the plain version:\n" + "\n".join(failed),
              flush=True)
    if any(not f.startswith("base ") for f in failed):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

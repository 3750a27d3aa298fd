"""The critical path of ``syevd_small`` (``tracking_tpu_torch/csrc/pca.cu``):
the longest chain of dependent floating-point operations (adds, products,
FMAs, divisions, square roots, in f32 and in the f64 sums of ``snrm2`` and
``sdot``) from the input matrix to an output, in the order the reference
(LAPACK and OpenBLAS as jaxlib runs them) fixes. No schedule of the same
arithmetic can take fewer dependent steps, so the count times an
operation's latency bounds the kernel's time from below.

The kernel's own source is compiled on the host with g++ (one thread a
block, barriers empty) with ``float`` and ``double`` replaced by types that
carry each value's depth (an operation's result: one more than its deepest
input; negation, ``fabsf``, ``copysignf``, ``fminf`` / ``fmaxf`` and loads
add nothing). Run:

    python tools/syevd_critical_path.py [N ...]   # default 20 32 64

on the Gram matrices of N frames of the 360x640 crop of ``chip_smoke.py``'s
seeded clip (the matrices its phase 6 times). Prints, for each N, the
depth and the depth times 4 cycles at 1,980 MHz, the H100 SXM's boost clock.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = r'''
#include <math.h>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <cstdint>
struct TD;
struct TF {
  float v; int d;
  TF() : v(0.0f), d(0) {}
  TF(float x) : v(x), d(0) {}
  TF(float x, int dd) : v(x), d(dd) {}
  explicit TF(const TD& x);
};
struct TD {
  double v; int d;
  TD() : v(0.0), d(0) {}
  TD(double x) : v(x), d(0) {}
  TD(double x, int dd) : v(x), d(dd) {}
  explicit TD(const TF& x) : v((double)x.v), d(x.d) {}
};
inline TF::TF(const TD& x) : v((float)x.v), d(x.d + 1) {}
static inline int dmax(int a, int b) { return a > b ? a : b; }
#define OPS(T, U)                                                                              \
  inline T operator+(const T& a, const T& b) { return T((U)(a.v + b.v), dmax(a.d, b.d) + 1); } \
  inline T operator-(const T& a, const T& b) { return T((U)(a.v - b.v), dmax(a.d, b.d) + 1); } \
  inline T operator*(const T& a, const T& b) { return T((U)(a.v * b.v), dmax(a.d, b.d) + 1); } \
  inline T operator/(const T& a, const T& b) { return T((U)(a.v / b.v), dmax(a.d, b.d) + 1); } \
  inline T operator-(const T& a) { return T(-a.v, a.d); }                                       \
  inline bool operator<(const T& a, const T& b) { return a.v < b.v; }                          \
  inline bool operator>(const T& a, const T& b) { return a.v > b.v; }                          \
  inline bool operator<=(const T& a, const T& b) { return a.v <= b.v; }                        \
  inline bool operator>=(const T& a, const T& b) { return a.v >= b.v; }                        \
  inline bool operator==(const T& a, const T& b) { return a.v == b.v; }                        \
  inline bool operator!=(const T& a, const T& b) { return a.v != b.v; }
OPS(TF, float)
OPS(TD, double)
inline TF fabsf(const TF& a) { return TF(std::fabs(a.v), a.d); }
inline TF copysignf(const TF& a, const TF& b) { return TF(std::copysign(a.v, b.v), dmax(a.d, b.d)); }
inline TF fmaxf(const TF& a, const TF& b) { return TF(std::fmax(a.v, b.v), dmax(a.d, b.d)); }
inline TF fminf(const TF& a, const TF& b) { return TF(std::fmin(a.v, b.v), dmax(a.d, b.d)); }
inline bool isnan(const TF& a) { return std::isnan(a.v); }
inline TF __fmaf_rn(const TF& a, const TF& b, const TF& c) { return TF(std::fmaf(a.v, b.v, c.v), dmax(dmax(a.d, b.d), c.d) + 1); }
inline TF __fsqrt_rn(const TF& a) { return TF(std::sqrt(a.v), a.d + 1); }
inline TF __fdiv_rn(const TF& a, const TF& b) { return a / b; }
inline TD __dsqrt_rn(const TD& a) { return TD(std::sqrt(a.v), a.d + 1); }
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
struct Dim { unsigned x; };
static Dim threadIdx, blockDim, blockIdx;
static unsigned char* emu_smem;
static inline void __syncthreads() {}
static inline int atomicMax(int* p, int v) { int o = *p; if (v > o) *p = v; return o; }
'''

DRIVER = r'''
extern "C" int depth(const float* G, int n) {
  for (int i = 0; i < 3 * EIG_N + 1; ++i) eig_offs[i] = emu_offs[i];
  static std::vector<TF> in;
  in.assign(G, G + n * n);
  std::vector<TF> W(n), V(n * n);
  std::vector<int> info(1);
  std::vector<unsigned char> buf(sizeof(EigShared));
  emu_smem = buf.data();
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
  syevd_small_kernel(in.data(), W.data(), V.data(), info.data(), n);
  int d = 0;
  for (auto& x : W) d = std::max(d, x.d);
  for (auto& x : V) d = std::max(d, x.d);
  return d;
}
'''


def build(workdir: str):
    src = open(os.path.join(ROOT, "tracking_tpu_torch", "csrc", "pca.cu")).read()
    body = src[src.index("// ---------------------------------------------------------------------------\n// syevd_small"):
               src.index("TT_EXPORT int tt_syevd_small")]
    body = body.replace("extern __shared__ __align__(16) unsigned char eig_smem[];", "unsigned char* eig_smem = emu_smem;")
    body = re.sub(r"\bdouble\b", "TD", re.sub(r"\bfloat\b", "TF", body))
    code = (HEADER + "#include <vector>\nstatic int emu_offs[3 * 64 + 1];\n" + body + DRIVER
            + 'extern "C" void set_table(const int* ops, int n_ops, const int* offs) {'
              " for (int i = 0; i < n_ops; ++i) eig_ops[i] = ops[i];"
              " for (int i = 0; i < 3 * EIG_N + 1; ++i) emu_offs[i] = offs[i]; }\n")
    cpp, so = os.path.join(workdir, "cp.cpp"), os.path.join(workdir, "cp.so")
    open(cpp, "w").write(code)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-o", so, cpp], check=True)
    return ctypes.CDLL(so)


def grams(ns):
    """The Gram matrices of n frames of the 360x640 crop of chip_smoke.py's clip."""
    import torch

    from tracking_tpu_torch.ops.contract import contract, gram_plan
    from tracking_tpu_torch.synth import make_clip

    clip = make_clip(1 + max(ns), 720, 1280, 3, seed=0)
    crop = torch.from_numpy(np.ascontiguousarray(clip[1:, :360, :640]))
    out = {}
    for n in ns:
        X = crop[:n].reshape(n, -1).to(torch.float32)
        Xc = X - X.sum(0) * np.float32(1.0 / n)
        G = contract(Xc, Xc.T, gram_plan(n, Xc.shape[1]))
        out[n] = ((G + G.T) * 0.5).contiguous().numpy()
    return out


def main(argv) -> None:
    import torch

    from tracking_tpu_torch.ops import eigh

    ns = [int(a) for a in argv] or [20, 32, 64]
    ops, offs = (t.numpy().astype(np.int32) for t in eigh._program_table("cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        lib.set_table(ops.ctypes.data_as(ctypes.c_void_p), len(ops), offs.ctypes.data_as(ctypes.c_void_p))
        torch.set_num_threads(4)
        for n, g in grams(ns).items():
            d = lib.depth(np.ascontiguousarray(g, np.float32).ctypes.data_as(ctypes.c_void_p), n)
            print(f"n = {n}: {d} dependent operations; at 4 cycles each and 1,980 MHz {d * 4 / 1.98e6:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

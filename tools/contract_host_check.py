"""Hold ``csrc/contract.cu``'s Gram product and lift (``tt_contract_gram``,
``tt_contract_lift``) against ``ops/contract.contract_ref`` on the host,
before the card: the kernel source compiled with g++ against a small CUDA
emulation (a CUDA thread a ``std::thread``, a block's barrier a blocking
barrier, the dynamic shared memory a buffer a block filled with NaN bytes,
``cp.async`` a plain copy, ``__fmaf_rn`` as ``fmaf``, ``-ffp-contract=off``
so that every other product and sum rounds on its own, two SMs so that the
lift's persistent CTAs walk several slabs), every plan form at small sizes
(1, 2 and 4 lanes, tails of rounded products, D mod 4 != 0 and rows that
are not 16-byte aligned, more than 32 blocks for the combine's batches, the
lift's narrow last panels and its 51-64-row orders), bit for bit.

    python tools/contract_host_check.py [--quick] [--mutants]

``--mutants`` also builds copies of the source with planted faults (a lane
join, a tail's rounding, the combine's order, the remainder's lane, the
lift's panel flag, block order and lane join) and three controls that
change nothing the plan fixes (a commuted addition, the mirrored half of a
diagonal tile, the blocks' sums started from the first block's: +0 + s
differs from s only where s is -0, which these sums of products from +0
are only on underflow), and reports which of them the check catches.
Needs g++ with C++20.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tracking_tpu_torch.ops import contract as C  # noqa: E402

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define TT_EXPORT extern "C" __attribute__((visibility("default")))
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __align__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
template <typename F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 2; return 0; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  long n, waiting = 0, gen = 0;
  explicit Barrier(long count) : n(count) {}
  void release() { waiting = 0; ++gen; cv.notify_all(); }
  void arrive_and_wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++waiting == n) { release(); return; }
    cv.wait(l, [&] { return gen != g; });
  }
  void arrive_and_drop() {
    std::unique_lock<std::mutex> l(m);
    if (--n > 0 && waiting == n) release();
  }
};
inline Barrier* g_bar;
inline char* g_smem;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline unsigned tt_blocks(int n, int threads) { return (unsigned)((n + threads - 1) / threads); }
template <typename... KA, typename... A>
void emu_launch(void (*k)(KA...), dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  blockDim = block;
  gridDim = grid;
  std::vector<char> sm(smem + 64);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(sm.data(), 0xff, sm.size());  // stale shared memory: NaN bytes
      g_smem = sm.data() + (16 - reinterpret_cast<uintptr_t>(sm.data()) % 16) % 16;
      Barrier bar((long)block.x);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          k(args...);
          bar.arrive_and_drop();
        });
      for (auto& th : ts) th.join();
    }
}
"""

GRAM = [(2, 37), (3, 4099), (4, 9), (5, 4101), (8, 8195), (8, 4098), (17, 90), (17, 89), (20, 9000), (20, 8193),
        (23, 4103), (25, 2051), (28, 2049), (32, 1030), (33, 5), (36, 4099), (41, 2050), (48, 2051), (49, 1027),
        (53, 1100), (64, 1536), (64, 1027), (8, 4096 * 34 + 5), (50, 512 * 37 + 3), (50, 512 * 64 + 7),
        (50, 512 * 96)]
LIFT = [(2, 37), (3, 100), (4, 16390), (4, 10), (6, 16388), (9, 8200), (11, 8195), (16, 4100), (17, 2051),
        (18, 2049), (20, 4096), (20, 2061), (24, 2050), (32, 2055), (33, 1030), (41, 1027), (42, 1029), (50, 1100),
        (51, 17), (51, 87), (52, 100), (53, 1100), (55, 70), (57, 41), (60, 63), (63, 33), (64, 128), (64, 129),
        (64, 1027), (12, 13), (9, 16)]
MUTANTS = {  # name: (text of the source, its replacement); "control" changes nothing the plan fixes
    "gram lane join (l0+l2)+(l1+l3)": (
        "s = (acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c]) + (acc[LANES > 2 ? 2 : 0][r][c] + acc[LANES > 3 ? 3 : 0][r][c]);",
        "s = (acc[0][r][c] + acc[LANES > 2 ? 2 : 0][r][c]) + (acc[LANES > 1 ? 1 : 0][r][c] + acc[LANES > 3 ? 3 : 0][r][c]);"),
    "gram tail fused": ("t = __fadd_rn(t, __fmul_rn(X[i * ldx + k], X[j * ldx + k]));",
                        "t = __fmaf_rn(X[i * ldx + k], X[j * ldx + k], t);"),
    "combine in pairs": ("    for (int r = 0; r < GRAM_INFLIGHT; ++r) acc = acc + va[r];",
                         "    for (int r = 0; r < GRAM_INFLIGHT; r += 2) acc = acc + (va[r] + va[r + 1]);"),
    "gram remainder lane": ("acc[u % LANES][r][c] =\n", "acc[(u + 1) % LANES][r][c] =\n"),
    "lift narrow panel fused": ("const bool fused = tab[2 + g] != 0;", "const bool fused = true;"),
    "lift blocks in reverse order": ("for (int bk = 0; bk < nb; ++bk) {", "for (int bk = nb - 1; bk >= 0; --bk) {"),
    "lift lane join (l0+l2)+(l1+l3)": ("sm = (acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c]) +",
                                       "sm = (acc[0][r][c] + acc[LANES > 2 ? 2 : 0][r][c]) +"),
    "control: the diagonal tile's mirrored half": ("(bi == bj && r > c)", "(bi == bj && r < c)"),
    "control: a commuted tail addition": ("        s = s + t;\n", "        s = t + s;\n"),
    # +0 + s differs from s only where s is -0: a sum of products from +0 is -0 only on underflow
    "control: the lift's blocks summed from the first's": ("o[r][c] = o[r][c] + sm;", "o[r][c] = bk ? o[r][c] + sm : sm;"),
}


def build(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    """The source with its launches through emu_launch and its dynamic
    shared memory from the block's buffer, compiled against the shim."""
    src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];", r"\1* \2 = (\1*)g_smem;", src)
    with open(os.path.join(out_dir, "common.cuh"), "w") as f:
        f.write(SHIM)
    cpp, lib = os.path.join(out_dir, f"{name}.cpp"), os.path.join(out_dir, f"{name}.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-I", out_dir,
                    cpp, "-o", lib], check=True)
    dll = ctypes.CDLL(lib)
    dll.tt_contract_gram.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.tt_contract_lift.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return dll


def rows(rng, s: int, d: int, ldx: int, off: int):
    """X [s, d] of row stride ldx, starting ``off`` floats past a 16-byte boundary; a column of -0.0."""
    buf = np.zeros(s * ldx + off + 8, np.float32)
    base = (-buf.ctypes.data // 4) % 4
    X = np.lib.stride_tricks.as_strided(buf[base + off:], (s, d), (4 * ldx, 4))
    X[...] = rng.standard_normal((s, d)).astype(np.float32)
    X[:, min(3, d - 1)] = -0.0
    return X, buf


def check(lib, quick: bool) -> list:
    """The (what) of every case whose output differs from contract_ref's in any bit."""
    rng = np.random.default_rng(26)
    gram, lift = (GRAM[::4] + GRAM[-2:], LIFT[::5]) if quick else (GRAM, LIFT)
    bad = []
    for kind, cases in (("gram", gram), ("lift", lift)):
        for s, d in cases:
            for ldx, off in ((d, 0), (d + 8 - d % 4, 0), (d, 1)):
                X, _buf = rows(rng, s, d, ldx, off)
                Xt = torch.from_numpy(np.ascontiguousarray(X))
                if kind == "gram":
                    plan = C.gram_plan(s, d)
                    tab = np.ascontiguousarray(C._gram_table(plan, "cpu").numpy())
                    part = np.zeros((tab.shape[1], s * (s + 1) // 2), np.float32)
                    out = np.full((s, s), np.nan, np.float32)
                    rc = lib.tt_contract_gram(X.ctypes.data, tab.ctypes.data, part.ctypes.data, out.ctypes.data, s,
                                              ldx, tab.shape[1], plan.lanes, None)
                    ref = C.contract_ref(Xt, Xt.T, plan).numpy()
                else:
                    L = rng.standard_normal((s, s)).astype(np.float32)
                    plan = C.lift_plan(s, d)
                    tab = np.ascontiguousarray(C._lift_table(plan, "cpu").numpy())
                    out = np.full((s, d), np.nan, np.float32)
                    rc = lib.tt_contract_lift(L.ctypes.data, X.ctypes.data, tab.ctypes.data, out.ctypes.data, s, d,
                                              ldx, tab.size, plan.lanes, plan.split if plan.alt is not None else d,
                                              None)
                    ref = C.contract_ref(torch.from_numpy(L), Xt, plan).numpy()
                if rc != 0 or not np.array_equal(out.view(np.int32), ref.view(np.int32)):
                    bad.append(f"{kind} S={s} D={d} ldx={ldx} off={off}")
    return bad


def main(argv) -> None:
    torch.set_num_threads(2)
    quick = "--quick" in argv
    src = open(os.path.join(ROOT, "tracking_tpu_torch", "csrc", "contract.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        bad = check(build(src, tmp, "contract"), quick)
        n = (len(GRAM[::4] + GRAM[-2:]) + len(LIFT[::5]) if quick else len(GRAM) + len(LIFT)) * 3
        print(f"{n} cases, {len(bad)} differ from contract_ref" + (f": {bad}" if bad else ""), flush=True)
        if "--mutants" in argv:
            for i, (name, (a, b)) in enumerate(MUTANTS.items()):
                if src.count(a) != 1:
                    raise SystemExit(f"mutant {name!r}: its text is not in the source once")
                caught = check(build(src.replace(a, b), tmp, f"mutant{i}"), quick)
                print(f"  {name}: {'caught' if caught else 'not caught'} ({len(caught)} cases differ)", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main(sys.argv[1:])

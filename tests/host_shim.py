"""Host builds of the port's CUDA headers for the CPU tests: each warp
of a block runs as 32 host threads that meet at every warp-wide exchange,
``tma.cuh`` and ``cp_async.cuh`` replaced by stand-ins that copy at once,
and a launch (``kernel<<<...>>>(...)``) turned into a call of
``host_launch``, which runs every block in turn with all its threads
together.  Built by g++ without contraction (the units' ``-fmad=false``),
a kernel's arithmetic gives the card's bits, except where the host picks
another NaN's payload (x86 takes it by operand order; the card makes one
canonical NaN).  Shared by ``test_torch_riccati_group.py`` (the DDP group
kernels) and ``test_torch_fmpc_group.py`` (the FMPC group kernels).
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch.kernels.build import CSRC

SHIM = r"""
// riccati_stage.cuh on the host: a 32-thread warp is 32 std::threads that
// meet at each shuffle (riccati_stage_group's LaneGroup<G>::bcast over the
// whole warp) at its warp's barrier; a thread that named another mask
// stops the run.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::fabs;
using std::isfinite;
using std::min;
using std::sqrt;
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local Dim3 threadIdx;
// A barrier of `count` threads: the last to arrive opens the next
// generation; the others spin briefly, then sleep on the generation word
// (a futex), so that a loaded machine does not run the waiters in place
// of the threads they wait for.
struct Barrier {
  explicit Barrier(unsigned n = 32) : count(n) {}
  std::atomic<unsigned> arrived{0}, gen{0};
  unsigned count;
  void arrive_and_wait() {
    const unsigned g = gen.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) + 1 == count) {
      arrived.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      gen.notify_all();
      return;
    }
    for (int i = 0; i < 64; ++i) {
      if (gen.load(std::memory_order_acquire) != g) return;
      __builtin_ia32_pause();
    }
    while (gen.load(std::memory_order_acquire) == g)
      gen.wait(g, std::memory_order_acquire);
  }
};
// one barrier and two sets of exchange slots per warp of a block (at most
// 32 warps), a warp's exchanges taking the sets in turn (each thread
// counts its own: every thread of a warp makes the same exchanges), so
// that an exchange needs one barrier: a set is written again only after
// the next exchange's barrier, which every reader of it has passed; a
// block barrier where a launch runs the block's warps together
static Barrier g_warps[32];
static int g_votes[32][2][32];
static unsigned long long g_slots[32][2][32];
thread_local unsigned t_exchanges = 0;
static Barrier* g_block = nullptr;
inline Barrier& g_warp_of() { return g_warps[threadIdx.x / 32]; }
inline void __syncthreads() {
  if (g_block) g_block->arrive_and_wait();
}
inline int __ffs(int v) { return __builtin_ffs(v); }
static void whole_warp(unsigned mask) {
  if (mask != 0xffffffffu) {
    std::fprintf(stderr, "thread %u: mask %08x\n", threadIdx.x, mask);
    std::exit(3);
  }
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  whole_warp(mask);
  int* votes = g_votes[threadIdx.x / 32][t_exchanges++ & 1];
  votes[threadIdx.x & 31] = pred != 0;
  g_warp_of().arrive_and_wait();
  unsigned bits = 0;
  for (int t = 0; t < 32; ++t)
    if (votes[t]) bits |= 1u << t;
  return bits;
}
inline bool __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}
template <typename T>
T __shfl_sync(unsigned mask, T v, int src, int width) {
  whole_warp(mask);
  unsigned long long* slots = g_slots[threadIdx.x / 32][t_exchanges++ & 1];
  std::memcpy(&slots[threadIdx.x & 31], &v, sizeof(T));
  g_warp_of().arrive_and_wait();
  T out;
  const int from = (static_cast<int>(threadIdx.x & 31) & ~(width - 1)) +
                   src % width;
  std::memcpy(&out, &slots[from], sizeof(T));
  return out;
}
"""

HOST_RUNTIME = r"""
#pragma once
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(x)
typedef void* cudaStream_t;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float __double2float_rn(double x) { return static_cast<float>(x); }
// rn_ops.cuh's MUFU seeds (rcp / rsqrt.approx.ftz.f64): the exact value
// cut to its 20 leading significand bits, so that the Newton steps after
// them do the work on the host too
namespace nmpc {
inline double rn_seed20(double v) {
  unsigned long long bits;
  std::memcpy(&bits, &v, sizeof bits);
  bits &= ~((1ull << 32) - 1);
  std::memcpy(&v, &bits, sizeof bits);
  return v;
}
inline double rn_rcp_seed(double x) { return rn_seed20(1.0 / x); }
inline double rn_rsqrt_seed(double x) { return rn_seed20(1.0 / std::sqrt(x)); }
}  // namespace nmpc
// the SM's cycle counter: the host's steady clock in nanoseconds
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
"""

HOST_CP_ASYNC = r"""
// cp_async.cuh on the host: a copy lands at once; the kernel's __syncwarp
// orders it for the other threads.
#pragma once
#include <cuda_runtime.h>
namespace nmpc {
template <typename T>
inline void cp_async(T* smem, const T* gmem) { *smem = *gmem; }
inline void cp_async_commit() {}
template <int PENDING>
inline void cp_async_wait() {}
template <typename Kernel>
int allow_dynamic_smem(Kernel, size_t bytes) {
  return bytes <= 227 * 1024 ? 0 : 1;
}
}  // namespace nmpc
"""

HOST_TMA = r"""
// tma.cuh on the host: encode_map_3d with the card's checks; a box lands
// at once (zero-filled past the array's bounds) and counts its bytes on
// its barrier, whose word holds the phases completed.  A wait checks that
// the phase it waits on completes, and that the barrier did not complete
// a later phase first (a buffer refilled before this thread read it);
// every arm, box and first-thread wait goes to the log with its block and
// warp, its values, and last the thread's place in its warp.  A waiting
// thread sleeps until a phase completes: a block's hundreds of threads
// spinning on sched_yield starve the one thread they wait for when other
// processes load the machine.
#pragma once
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
namespace nmpc {
struct CUtensorMap {
  const unsigned char* base;
  int n0, n1, n2, ld, b0, b1, b2, size;
};
template <typename T>
int encode_map_3d(CUtensorMap* map, const void* base, int n0, int n1,
                  int n2, int ld, int b0, int b1, int b2) {
  const uint64_t row = static_cast<uint64_t>(ld) * sizeof(T);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || row % 16 != 0 ||
      ld < n0 || (b0 * sizeof(T)) % 16 != 0 || b0 > 256 || b1 > 256 ||
      b2 > 256 || b0 <= 0 || b1 <= 0 || b2 <= 0)
    return 1;
  *map = {static_cast<const unsigned char*>(base), n0, n1, n2, ld, b0, b1,
          b2, static_cast<int>(sizeof(T))};
  return 0;
}
struct Pending {
  int count = 1, left = 1;
  int64_t bytes = 0;
};
inline std::mutex g_lock;
inline std::condition_variable g_phase;   // a phase completed
inline std::map<const uint64_t*, Pending> g_pending;
inline FILE* g_log = nullptr;
thread_local std::map<const uint64_t*, uint64_t> t_waits;
inline void fail(int code, const char* what) {
  std::fprintf(stderr, "%s\n", what);
  std::exit(code);
}
inline int offset(const void* p) {
  return static_cast<int>(static_cast<const unsigned char*>(p) - smem_raw);
}
inline void log_event(const char* what, int a, int b = 0, int c = 0,
                      int d = 0) {
  if (g_log)
    std::fprintf(g_log, "%s %u %u %d %d %d %d %u\n", what, blockIdx.x,
                 threadIdx.x / 32, a, b, c, d, threadIdx.x % 32);
}
// under g_lock: the phase completes once every arrival and byte is in
inline void settle(uint64_t* bar, Pending& p) {
  if (p.left < 0) fail(9, "more arrivals than a barrier's count");
  if (p.left == 0 && p.bytes == 0) {
    p.left = p.count;
    std::atomic_ref<uint64_t>(*bar).fetch_add(1);
    g_phase.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, uint32_t count = 1) {
  std::lock_guard<std::mutex> hold(g_lock);
  std::atomic_ref<uint64_t>(*bar).store(0);
  g_pending[bar] = Pending{static_cast<int>(count),
                           static_cast<int>(count), 0};
}
inline void mbar_arm(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> hold(g_lock);
  Pending& p = g_pending[bar];
  p.bytes += bytes;
  --p.left;
  log_event("A", offset(bar), static_cast<int>(bytes));
  settle(bar, p);
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> hold(g_lock);
  Pending& p = g_pending[bar];
  --p.left;
  settle(bar, p);
}
inline void tma_load_3d(const CUtensorMap& m, uint64_t* bar, void* dst,
                        int c0, int c1, int c2) {
  if (reinterpret_cast<uintptr_t>(dst) % 128 != 0)
    fail(8, "a box lands at a shared address not 128-byte aligned");
  if ((static_cast<long long>(c0) * m.size) % 16 != 0)
    fail(13, "a box starts at a row offset not 16-byte aligned");
  unsigned char* out = static_cast<unsigned char*>(dst);
  for (int z = 0; z < m.b2; ++z)
    for (int y = 0; y < m.b1; ++y)
      for (int x = 0; x < m.b0; ++x, out += m.size) {
        const int i0 = c0 + x, i1 = c1 + y, i2 = c2 + z;
        if (i0 < 0 || i0 >= m.n0 || i1 < 0 || i1 >= m.n1 || i2 < 0 ||
            i2 >= m.n2) {
          std::memset(out, 0, m.size);
          continue;
        }
        std::memcpy(out, m.base + ((static_cast<size_t>(i2) * m.n1 + i1) *
                                       m.ld + i0) * m.size,
                    m.size);
      }
  std::lock_guard<std::mutex> hold(g_lock);
  const int bytes = m.b0 * m.b1 * m.b2 * m.size;
  log_event("L", c0, c2, offset(dst), bytes);
  Pending& p = g_pending[bar];
  p.bytes -= bytes;
  settle(bar, p);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint64_t use = t_waits[bar]++;
  if ((use & 1) != parity) fail(11, "a wait names the wrong parity");
  const auto until = std::chrono::steady_clock::now() +
                     std::chrono::seconds(20);
  std::unique_lock<std::mutex> hold(g_lock);
  const auto done = [bar] { return std::atomic_ref<uint64_t>(*bar).load(); };
  if (!g_phase.wait_until(hold, until, [&] { return done() > use; }))
    fail(6, "a wait on a phase that never completes");
  if (done() != use + 1)
    fail(7, "a buffer refilled before this thread read it");
  if (threadIdx.x % 32 == 0) log_event("W", offset(bar));
}
}  // namespace nmpc
"""

# After SHIM: the block and warp state a kernel reads, shared memory, the
# TMA stand-in and host_launch; a harness then includes the kernels'
# headers.
KERNELS_PRELUDE = r"""
#include <cuda_runtime.h>
thread_local Dim3 blockIdx, blockDim;
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  whole_warp(mask);
  g_warp_of().arrive_and_wait();
}
namespace nmpc {
alignas(128) unsigned char smem_raw[1 << 20];
}
#include "tma.cuh"
// every block in turn (a grid of blocks along x, or x and y), its threads
// all together (the warps of a block meet at __syncthreads and the rings);
// shared memory poisoned (NaN) before a block and checked past the
// launch's size after
template <typename Kernel>
auto host_launch(dim3 grid, int block, size_t smem, cudaStream_t,
                 Kernel* kernel) {
  return [=](auto... args) {
    if (smem + 4096 > sizeof(nmpc::smem_raw) || block > 32 * 32 ||
        block % 32 != 0)
      std::exit(12);
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::memset(nmpc::smem_raw, 0xff, sizeof(nmpc::smem_raw));
        Barrier all(block);
        g_block = &all;
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            blockIdx.x = bx;
            blockIdx.y = by;
            blockDim.x = block;
            threadIdx.x = t;
            kernel(args...);
          });
        for (auto& th : threads) th.join();
        g_block = nullptr;
        for (size_t i = smem; i < smem + 4096; ++i)
          if (nmpc::smem_raw[i] != 0xff) std::exit(10);
      }
  };
}
"""


def bits(a):
    """``a``'s bit pattern."""
    return a.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64}[a.dtype])


def same(a, b):
    """NaN where ``a`` is NaN and the same bits everywhere else (the host
    compiler may swap the operands of a sum or product, which picks
    another NaN's payload on x86; the card makes one canonical NaN)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(bits(a[~nan]), bits(b[~nan])))


def first_apart(a, b):
    """The first flat index where ``a`` and ``b`` are not :func:`same`
    (a NaN against a NaN counts as equal), or None."""
    a, b = a.flatten(), b.flatten()
    nan = torch.isnan(a) & torch.isnan(b)
    apart = (bits(a) != bits(b)) & ~nan
    return int(apart.nonzero()[0]) if bool(apart.any()) else None


def exact_sqrt(a):
    """A correctly rounded sqrt (numpy's), as the card's and the host
    build's; torch's vectorized CPU sqrt is not, at fp32 or fp64."""
    return torch.from_numpy(np.sqrt(a.numpy()))


_LAUNCH = re.compile(r"(\w+<[^<>;]*>)\s*<<<(.*?)>>>", re.DOTALL)


def host_fma_flags() -> tuple:
    """``-mfma`` where the host CPU has fused multiply-add (x86's FMA3),
    so that a kernel's explicit fma() (``rn_ops.cuh``) runs as one
    instruction and not as libm's software fma; () elsewhere.  Either
    gives fma's exact rounding; contraction stays off."""
    try:
        flags = Path("/proc/cpuinfo").read_text().split()
    except OSError:
        return ()
    return ("-mfma",) if "fma" in flags else ()


def build_kernels_host(d: Path, source: str, name: str,
                       opt: str = "-O1", extra: tuple = ()) -> Path:
    """The executable of the harness ``source`` (SHIM + KERNELS_PRELUDE +
    its includes and main) built by g++ in ``d`` from a copy of csrc/ with
    the launches turned into host_launch calls and the stand-ins for
    tma.cuh, cp_async.cuh and cuda_runtime.h, without contraction, with
    the g++ flags ``extra``; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    inc = d / "csrc"
    inc.mkdir()
    for header in CSRC.glob("*.cuh"):
        (inc / header.name).write_text(
            _LAUNCH.sub(r"::host_launch(\2, \1)", header.read_text()))
    (inc / "tma.cuh").write_text(HOST_TMA)
    (inc / "cp_async.cuh").write_text(HOST_CP_ASYNC)
    (d / "cuda_runtime.h").write_text(HOST_RUNTIME)
    (d / f"{name}.cpp").write_text(source)
    exe = d / name
    proc = subprocess.run([gxx, "-std=c++20", opt, *extra,
                           "-ffp-contract=off",
                           "-pthread", f"-I{d}", f"-I{inc}", "-o", str(exe),
                           str(d / f"{name}.cpp")],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[:4000]
    return exe

// K4 at the wide shapes: the boxed DDP Riccati backward fed by the
// derivative sweep, for Hopper (sm_90a), where (NX, NU) passes K4's
// one-group stage (4 < nu <= 16 at nx <= 9; the centroidal model's
// (9, 16) with its 16 contact forces boxed).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas_boxed at those shapes (_backward_pallas_call_boxed
// :1018, stage _riccati_stage_boxed :433, QP _boxqp_t :182), as
// ddp_backward_boxed.cuh does at the others; its plain version is
// nmpc_tpu_torch/kernels/ddp_backward.py::backward_stacked_boxed.  The
// wrapper (kernels/ddp_backward_boxed.py) builds this header's launch for
// a wide shape and ddp_backward_boxed.cuh's for any other.
//
// What bounds it on the card: each lane's chain of N dependent stages, as
// for K1 at (9, 16) (ddp_backward_wide.cuh), with a projected-Newton QP on
// the chain of each stage.  At (9, 16) a stage reads 731 field values and
// 48 bound values and writes 160 gains a lane (96 MB at B=256, N=100,
// fp32: 29 us at 3.35 TB/s), but each QP iteration is a 16 x 16 masked
// Cholesky (16 dependent pivots, a square root and a division each) and
// two triangular solves (32 dependent divisions) before its Armijo
// search, and K's solves add 32 more divisions, beside the Q expansion's
// and the value update's chains: the stage's latency, whatever the batch.
// The data runs ~14 QP iterations a lane and stage (PERF.md), and a
// batch runs at its slowest lane's QP work.
//
// What the design does about it: one lane a block (a consumer warp at G =
// kWideGroup = 32 threads a lane, and a producer warp), so that no lane
// waits for another's QP work, fed by a ring of kBoxedWideRing one-stage
// TMA buffers, each stage's ten boxes (K1's seven fields, then lower,
// upper and u) 16 bytes of lanes wide; boxqp_wide.cuh's stage on the
// lane's threads, which split every NU x NU product and factor by rows
// through the lane's scratch in shared memory (WideBoxedScratch, after
// the ring), keep the Cholesky's sums running, divide and take roots at
// fp32 straight-line (rn_ops.cuh), and evaluate the Armijo schedule G
// candidates at a time from the block's step table (after the scratch;
// boxqp.cuh::fill_step_table, at most kWideStepTable steps: the schedule
// cut where a step falls below min_step, armijo_steps).  The block's
// sizes are checked when the unit compiles.  As in K1 and K4, a lane past
// the batch's end runs the last lane's column and stores nothing.  With a
// non-null qp_stats the kernel also stores each
// (stage, lane)'s QP iterations, free set (bit a: input a free) and
// Armijo candidates visited ([3][N][B] ints), for the tests and
// chip_smoke.py; the profile build (P, off in every launch of the
// solver) adds each boxqp_wide.cuh::WidePhase's cycles after them
// ([3 + kWidePhases][N][B]), its arithmetic the normal build's.

#pragma once

#include "boxqp_wide.cuh"
#include "ddp_backward_wide.cuh"

namespace nmpc {

// A block's lanes: one consumer warp's, 32 / G (one at G = 32), so that
// no lane waits for another's QP work (with a block of four, the ring's
// buffer of a stage was refilled only after the slowest of the four had
// used it); its TMA boxes `box` lanes wide, at least 16 bytes (TMA's
// least box row: 4 lanes fp32, 2 fp64), from the 16-byte aligned lane at
// or before the block's first (a box starting elsewhere is an illegal
// instruction on the card).
template <typename T, int G>
struct BoxedWideLanes {
  static constexpr int lanes = 32 / G;
  static constexpr int box = lanes * static_cast<int>(sizeof(T)) >= 16
                                 ? lanes
                                 : 16 / static_cast<int>(sizeof(T));
  // a field's offset, in values, that makes 128 bytes over the box
  static constexpr int align = box * static_cast<int>(sizeof(T)) >= 128
                                   ? 1
                                   : 128 / (box * static_cast<int>(sizeof(T)));
};

// A ring buffer's layout: K1's fields (StageLayout), then the bounds
// lower, upper and u, each at a 128-byte boundary of the box.
template <typename T, int NX, int NU, int G>
struct BoxedWideLayout : StageLayout<NX, NU, BoxedWideLanes<T, G>::align> {
  using Base = StageLayout<NX, NU, BoxedWideLanes<T, G>::align>;
  static constexpr int lower = Base::F;
  static constexpr int upper = Base::up(lower + NU);
  static constexpr int u = Base::up(upper + NU);
  static constexpr int F = Base::up(u + NU);
};

// The most Armijo steps (armijo_steps) the block's table holds.
constexpr int kWideStepTable = 512;

// The Armijo steps a search can visit (ddp_backward_boxed.py::
// armijo_steps): max_ls_iter + 1, or k + 1 where step k of 1, f, f^2, ...
// (formed at T as fill_step_table forms them) is the first below
// min_step, where the search stops exhausted whatever Armijo says.  A
// schedule cut there is the same search: its last candidate stops it
// either way, with the same exhaustion bit.
template <typename T>
int armijo_steps(const BoxQPParams& p) {
  const T f = T(p.step_factor), below = T(p.min_step);
  T step = T(1);
  for (int k = 0; k <= p.max_ls_iter; ++k) {
    if (step < below) return k + 1;
    if (step * f == step) break;   // a fixed point: no later step differs
    step = step * f;
  }
  return p.max_ls_iter + 1;
}

// The ring's buffers: two, the producer filling one while the lane works
// on the other (a stage's boxes land in about a microsecond, a stage's QP
// takes tens).
constexpr int kBoxedWideRing = 2;

// The wide boxed block's size rules: its lanes and box (BoxedWideLanes),
// the ring's kBoxedWideRing buffers in BoxedWideLayout, then each lane's
// WideBoxedScratch `stride` values apart (as ddp_backward_wide.cuh::
// WideBlock's: rounded up to 128 bytes plus G values modulo 128 bytes),
// then the step table; `threads` with the producer warp.
template <typename T, int NX, int NU, int G>
struct WideBoxedBlock {
  using Lanes = BoxedWideLanes<T, G>;
  using Layout = BoxedWideLayout<T, NX, NU, G>;
  static constexpr int lanes = Lanes::lanes;
  static constexpr int box = Lanes::box;
  static constexpr int ring = kBoxedWideRing;
  static constexpr int per = 128 / static_cast<int>(sizeof(T));
  static constexpr int stride =
      (WideBoxedScratch<NX, NU>::size + per - 1) / per * per + G % per;
  static constexpr size_t bytes =
      ring_bytes<T>(ring, 1, Layout::F, box) +
      static_cast<size_t>(lanes) * stride * sizeof(T) +
      kWideStepTable * sizeof(T);
  static constexpr int threads = lanes * G + 32;
};

// The boxed kernel's tensor maps, one per field ([N, size, B]: Fx, Fu,
// Lx, Lu, Lxx, Luu, Lxu, lower, upper, u).
struct BoxedFieldMaps {
  CUtensorMap field[10];
};

// The recursion of one lane's group: the terminal carry and a zero warm
// start into the lane's scratch `s`, then every stage from the end of the
// horizon (`feed` as K1's, its slab L lanes wide), its gains stored by
// the group (value q by rank q % G), and dV and ok (and, with qp_stats,
// the QP's iterations, free sets and Armijo candidates) by rank 0.
template <typename T, int NX, int NU, int G, int L, typename Layout, bool P,
          typename Feed>
__device__ __forceinline__ void boxed_wide_backward(
    Feed& feed, const GroupLane<G>& at, int N, int B, int reg_type,
    const BoxQPParams& qp, const T* steps, const T* __restrict__ VxT,
    const T* __restrict__ VxxT, const T* __restrict__ lam_in,
    const BackwardOut<T>& out, int* __restrict__ qp_stats, T* s) {
  using W = WideScratch<NX, NU>;
  using S = WideBoxedScratch<NX, NU>;
  const int r = LaneGroup<G>::rank();
  for (int e = r; e < NX + NX * NX; e += G)   // Vx, then Vxx, at W::Vx
    s[W::Vx + e] = e < NX ? VxT[static_cast<size_t>(e) * B + at.b]
                          : VxxT[static_cast<size_t>(e - NX) * B + at.b];
  for (int e = r; e < NU; e += G) s[S::Kn + e] = T(0);
  __syncwarp();
  const T lam = lam_in[at.b];
  T dV0 = T(0), dV1 = T(0);
  bool ok = true;
  PhaseClock<P> clk;
  for (int c = 0; c < N; ++c) {
    clk.start();
    const T* slab = feed.acquire(c);
    clk.lap(kPhWait);
    int iters, evals;
    unsigned free_set;
    riccati_stage_boxed_wide<T, NX, NU, G, L, Layout>(
        slab, lam, reg_type, qp, steps, s, dV0, dV1, ok, iters, evals,
        free_set, clk);
    if (at.live) {
      const int i = N - 1 - c;
      constexpr int EG = (NU * (NX + 1) + G - 1) / G;   // values a thread
      // not unrolled: unrolled, the compiler keeps each store's lane
      // offset from the kernel's start, and the fp64 unit spilled them
#pragma unroll 1
      for (int j = 0; j < EG; ++j) {
        const int e = j * G + r;
        if (EG * G == NU * (NX + 1) || e < NU * (NX + 1)) {
          const int a = e / (NX + 1), col = e % (NX + 1);
          const T v = s[W::X + a * W::XS + col];
          if (col == 0)
            out.ks[idx2(i, a, NU, at.b, B)] = v;
          else
            out.Ks[idx3(i, a, col - 1, NU, NX, at.b, B)] = v;
        }
      }
      if (qp_stats != nullptr && r == 0) {
        int* q = qp_stats + static_cast<size_t>(i) * B + at.b;
        const size_t NB = static_cast<size_t>(N) * B;
        q[0] = iters;
        q[NB] = static_cast<int>(free_set);
        q[2 * NB] = evals;
      }
    }
    clk.lap(kPhStore);
    if constexpr (P) {
      if (at.live && qp_stats != nullptr && r == 0) {
#pragma unroll
        for (int q = 0; q < kWidePhases; ++q)
          qp_stats[((3 + q) * static_cast<size_t>(N) + N - 1 - c) * B +
                   at.b] = static_cast<int>(clk.acc[q]);
      }
    }
  }
  if (at.live && r == 0) {
    out.dV[at.b] = dV0;
    out.dV[static_cast<size_t>(B) + at.b] = dV1;
    out.ok[at.b] = ok ? 1 : 0;
  }
}

// A block: one consumer warp (Block::lanes lanes of G threads), then one
// producer warp filling the ring from the end of the horizon, ten boxes a
// stage, each Block::box lanes wide from the box-aligned lane at or
// before the block's first (the lanes past the batch zero-filled); the
// lanes' scratch after the ring, the step table after the scratch.
template <typename T, int NX, int NU, int G, bool P>
__global__ void __launch_bounds__(WideBoxedBlock<T, NX, NU, G>::threads)
ddp_backward_boxed_wide_kernel(const __grid_constant__ BoxedFieldMaps maps,
                               const T* __restrict__ VxT,
                               const T* __restrict__ VxxT,
                               const T* __restrict__ lam_in, BoxQPParams qp,
                               BackwardOut<T> out, int* __restrict__ qp_stats,
                               int N, int B, int reg_type) {
  using Block = WideBoxedBlock<T, NX, NU, G>;
  using Layout = typename Block::Layout;
  constexpr int R = Block::ring, L = Block::lanes, LB = Block::box;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the box's first lane: the block's, or the aligned one before it
  const int base = static_cast<int>(blockIdx.x) * L / LB * LB;
  const StageRing<T, R> ring(smem_raw, packed_buffer_bytes<T>(1, Layout::F,
                                                              LB));
  T* scratch = reinterpret_cast<T*>(
      smem_raw + ring_bytes<T>(R, 1, Layout::F, LB));
  T* steps = scratch + static_cast<size_t>(L) * Block::stride;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s]);   // the consumer warp
    }
  }
  fill_step_table<T>(steps, qp);   // ends in the block's barrier
  if (static_cast<int>(threadIdx.x) >= L * G) {       // the producer warp
    if (threadIdx.x % 32 != 0) return;
    auto load = [&maps, base, N](int c, T* dst, uint64_t* bar) {
      constexpr int offset[10] = {Layout::Fx,    Layout::Fu,    Layout::Lx,
                                  Layout::Lu,    Layout::Lxx,   Layout::Luu,
                                  Layout::Lxu,   Layout::lower, Layout::upper,
                                  Layout::u};
      mbar_arm(bar, static_cast<uint32_t>(
                        (PackedLayout<NX, NU>::F + 3 * NU) * LB * sizeof(T)));
#pragma unroll
      for (int f = 0; f < 10; ++f)
        tma_load_3d(maps.field[f], bar, dst + offset[f] * LB, base, 0,
                    N - 1 - c);
    };
    ring.produce(N, load);
    return;
  }
  const GroupLane<G> at(B, L);
  StageRingFeed<T, R> feed{ring, at.b - base, LB};
  boxed_wide_backward<T, NX, NU, G, LB, Layout, P>(
      feed, at, N, B, reg_type, qp, steps, VxT, VxxT, lam_in, out, qp_stats,
      scratch + static_cast<size_t>(threadIdx.x / G) * Block::stride);
}

// Launch on `stream`; returns a CUDA error code (cudaErrorInvalidValue
// for an empty batch or horizon, or an Armijo schedule past the table:
// armijo_steps > kWideStepTable).  The QP runs the schedule cut to
// armijo_steps.  fields: Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, lower, upper, u,
// each batch-minor [N, size, B] with its lanes ld values apart (ld *
// sizeof(T) and each address multiples of 16 bytes); VxT [NX, B], VxxT
// [NX, NX, B], lam [B] contiguous; ok is one byte per lane; qp_stats null
// or [3][N][B] ints ([3 + kWidePhases][N][B] in the profile build P).  G
// is the threads per lane; kWideGroup unless a measurement asks for
// another.
template <typename T, int NX, int NU, int G = kWideGroup, bool P = false>
int launch_backward_boxed_wide(int N, int B, int ld, int reg_type,
                               BoxQPParams qp, const void* const* fields,
                               const void* VxT, const void* VxxT,
                               const void* lam, void* ks, void* Ks, void* dV,
                               void* ok, void* qp_stats, void* stream) {
  using Block = WideBoxedBlock<T, NX, NU, G>;
  static_assert(Block::bytes <= kMaxBlockSmem,
                "a wide boxed block's ring, scratch and table pass its "
                "shared memory");
  if (B <= 0 || N <= 0 || qp.max_ls_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = armijo_steps<T>(qp);
  if (steps > kWideStepTable) return static_cast<int>(cudaErrorInvalidValue);
  qp.max_ls_iter = steps - 1;
  const int sizes[10] = {NX * NX, NX * NU, NX, NU, NX * NX,
                         NU * NU, NX * NU, NU, NU, NU};
  BoxedFieldMaps maps;
  for (int f = 0; f < 10; ++f) {
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, sizes[f],
                                     N, ld, Block::box, sizes[f], 1);
    if (err != 0) return err;
  }
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  const int err = allow_dynamic_smem(
      ddp_backward_boxed_wide_kernel<T, NX, NU, G, P>, Block::bytes);
  if (err != 0) return err;
  ddp_backward_boxed_wide_kernel<T, NX, NU, G, P>
      <<<(B + Block::lanes - 1) / Block::lanes, Block::threads, Block::bytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), qp, out, static_cast<int*>(qp_stats), N,
          B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

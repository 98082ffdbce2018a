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
//
// What the design does about it: K1-wide's block (ddp_backward_wide.cuh)
// with its producer warp and ring of one-stage TMA buffers, each stage's
// ten boxes (K1's seven fields, then lower, upper and u), whose consumers
// run boxqp_wide.cuh's stage on G = kWideGroup threads a lane (32: a lane
// a warp), the threads splitting every NU x NU product and factor by rows
// through the lane's scratch in shared memory (WideBoxedScratch, after
// the ring), the Armijo schedule evaluated G candidates at a time from
// the block's step table (after the scratch; boxqp.cuh::fill_step_table,
// at most kWideStepTable steps).  A block holds WideBoxedBlock::lanes(B)
// lanes: at least 4, as many as keep it within 8 warps and its ring of two
// buffers, scratch and table within 227 KB (4 at (9, 16), G = 32), the
// ring as many buffers as then fit (8 at fp32, 6 at fp64), checked when
// the unit compiles.  As in K1 and K4, a lane past the batch's end runs
// the last lane's column and stores nothing, and a warp wholly past it
// returns at once.  With a non-null qp_stats the kernel also stores each
// (stage, lane)'s QP iterations, free set (bit a: input a free) and
// Armijo candidates visited ([3][N][B] ints), for the tests and
// chip_smoke.py.

#pragma once

#include "boxqp_wide.cuh"
#include "ddp_backward_wide.cuh"

namespace nmpc {

// A ring buffer's layout: K1-wide's fields (WideRingLayout), then the
// bounds lower, upper and u, each at the same alignment.
template <typename T, int NX, int NU, int G>
struct BoxedWideLayout : WideRingLayout<T, NX, NU, G> {
  static constexpr int Q = wide_stage_align<T, G>();
  static constexpr int up(int v) { return (v + Q - 1) / Q * Q; }
  static constexpr int lower = WideRingLayout<T, NX, NU, G>::F;
  static constexpr int upper = up(lower + NU);
  static constexpr int u = up(upper + NU);
  static constexpr int F = up(u + NU);
};

// The most Armijo steps (max_ls_iter + 1) the block's table holds.
constexpr int kWideStepTable = 512;

// The wide boxed block's size rules (ddp_backward_wide.cuh::WideBlock):
// the ring's buffers in BoxedWideLayout, WideBoxedScratch a lane, the
// step table after the scratch.
template <typename T, int NX, int NU, int G>
using WideBoxedBlock =
    WideBlock<T, G, BoxedWideLayout<T, NX, NU, G>::F,
              WideBoxedScratch<NX, NU>::size, kWideStepTable * sizeof(T)>;

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
template <typename T, int NX, int NU, int G, int L, typename Layout,
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
  for (int c = 0; c < N; ++c) {
    const T* slab = feed.acquire(c);
    int iters, evals;
    unsigned free_set;
    riccati_stage_boxed_wide<T, NX, NU, G, L, Layout>(
        slab, lam, reg_type, qp, steps, s, dV0, dV1, ok, iters, evals,
        free_set);
    if (at.live) {
      const int i = N - 1 - c;
      constexpr int EG = (NU * (NX + 1) + G - 1) / G;   // values a thread
#pragma unroll
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
        qp_stats[static_cast<size_t>(i) * B + at.b] = iters;
        qp_stats[(static_cast<size_t>(N) + i) * B + at.b] =
            static_cast<int>(free_set);
        qp_stats[(2 * static_cast<size_t>(N) + i) * B + at.b] = evals;
      }
    }
  }
  if (at.live && r == 0) {
    out.dV[at.b] = dV0;
    out.dV[static_cast<size_t>(B) + at.b] = dV1;
    out.ok[at.b] = ok ? 1 : 0;
  }
}

// A block: L lanes of G threads (the consumer warps), then one producer
// warp filling K1's ring from the end of the horizon, ten boxes a stage;
// the lanes' scratch after the ring, the step table after the scratch.
// One kernel for each L a launch takes, so that the slab's lane stride is
// a constant.
template <typename T, int NX, int NU, int G, int L>
__global__ void __launch_bounds__(L * G + 32)
ddp_backward_boxed_wide_kernel(const __grid_constant__ BoxedFieldMaps maps,
                               const T* __restrict__ VxT,
                               const T* __restrict__ VxxT,
                               const T* __restrict__ lam_in, BoxQPParams qp,
                               BackwardOut<T> out, int* __restrict__ qp_stats,
                               int N, int B, int reg_type) {
  using Layout = BoxedWideLayout<T, NX, NU, G>;
  using Block = WideBoxedBlock<T, NX, NU, G>;
  constexpr int W = 32 / G;
  constexpr int R = Block::ring();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const StageRing<T, R> ring(smem_raw, packed_buffer_bytes<T>(1, Layout::F,
                                                              L));
  T* scratch = reinterpret_cast<T*>(
      smem_raw + ring_bytes<T>(R, 1, Layout::F, L));
  T* steps = scratch + static_cast<size_t>(L) * Block::stride;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], (lanes + W - 1) / W);   // warps with lanes
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
                        (PackedLayout<NX, NU>::F + 3 * NU) * L * sizeof(T)));
#pragma unroll
      for (int f = 0; f < 10; ++f)
        tma_load_3d(maps.field[f], bar, dst + offset[f] * L, base, 0,
                    N - 1 - c);
    };
    ring.produce(N, load);
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  StageRingFeed<T, R> feed{ring, at.b - base, L};
  boxed_wide_backward<T, NX, NU, G, L, Layout>(
      feed, at, N, B, reg_type, qp, steps, VxT, VxxT, lam_in, out, qp_stats,
      scratch + static_cast<size_t>(threadIdx.x / G) * Block::stride);
}

// The launch at lanes == L, else at the next L up to the block's most.
template <typename T, int NX, int NU, int G, int L>
int launch_boxed_wide_lanes(int lanes, int N, int B, int reg_type,
                            const BoxQPParams& qp, const BoxedFieldMaps& maps,
                            const T* VxT, const T* VxxT, const T* lam,
                            const BackwardOut<T>& out, int* qp_stats,
                            cudaStream_t stream) {
  using Block = WideBoxedBlock<T, NX, NU, G>;
  if constexpr (L > Block::max_lanes()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (lanes != L)
      return launch_boxed_wide_lanes<T, NX, NU, G, 2 * L>(
          lanes, N, B, reg_type, qp, maps, VxT, VxxT, lam, out, qp_stats,
          stream);
    const size_t smem = Block::bytes(Block::ring(), L);
    const int err = allow_dynamic_smem(
        ddp_backward_boxed_wide_kernel<T, NX, NU, G, L>, smem);
    if (err != 0) return err;
    ddp_backward_boxed_wide_kernel<T, NX, NU, G, L>
        <<<(B + L - 1) / L, L * G + 32, smem, stream>>>(
            maps, VxT, VxxT, lam, qp, out, qp_stats, N, B, reg_type);
    return static_cast<int>(cudaGetLastError());
  }
}

// Launch on `stream`; returns a CUDA error code (cudaErrorInvalidValue
// for an empty batch or horizon, or an Armijo schedule past the table:
// max_ls_iter + 1 > kWideStepTable).  fields: Fx, Fu, Lx, Lu, Lxx, Luu,
// Lxu, lower, upper, u, each batch-minor [N, size, B] with its lanes ld
// values apart (ld * sizeof(T) and each address multiples of 16 bytes);
// VxT [NX, B], VxxT [NX, NX, B], lam [B] contiguous; ok is one byte per
// lane; qp_stats null or [3][N][B] ints.  G is the threads per lane;
// kWideGroup unless a measurement asks for another.
template <typename T, int NX, int NU, int G = kWideGroup>
int launch_backward_boxed_wide(int N, int B, int ld, int reg_type,
                               BoxQPParams qp, const void* const* fields,
                               const void* VxT, const void* VxxT,
                               const void* lam, void* ks, void* Ks, void* dV,
                               void* ok, void* qp_stats, void* stream) {
  using Block = WideBoxedBlock<T, NX, NU, G>;
  static_assert(Block::bytes(Block::ring(), Block::max_lanes()) <=
                    kMaxBlockSmem,
                "a wide boxed block's ring, scratch and table pass its "
                "shared memory");
  static_assert(Block::max_lanes() * G + 32 <= kWideMaxThreads,
                "a wide boxed block passes its threads");
  if (B <= 0 || N <= 0 || qp.max_ls_iter < 0 ||
      qp.max_ls_iter + 1 > kWideStepTable)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = Block::lanes(B);
  const int sizes[10] = {NX * NX, NX * NU, NX, NU, NX * NX,
                         NU * NU, NX * NU, NU, NU, NU};
  BoxedFieldMaps maps;
  for (int f = 0; f < 10; ++f) {
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, sizes[f],
                                     N, ld, L, sizes[f], 1);
    if (err != 0) return err;
  }
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  return launch_boxed_wide_lanes<T, NX, NU, G, wide_min_lanes<G>()>(
      L, N, B, reg_type, qp, maps, static_cast<const T*>(VxT),
      static_cast<const T*>(VxxT), static_cast<const T*>(lam), out,
      static_cast<int*>(qp_stats), static_cast<cudaStream_t>(stream));
}

}  // namespace nmpc

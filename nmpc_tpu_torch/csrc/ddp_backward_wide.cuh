// K1 at the wide shapes: the sweep-fed DDP Riccati backward for Hopper
// (sm_90a) where (NX, NU) passes the narrow kernels' sizes (row_group.
// cuh::kWideStage: nx > 8 or nu > 4; the centroidal model's (9, 16)).
// Its block, stage and recursion (wide_backward) are K2's and K3's there
// too (ddp_backward_chunked_wide.cuh, ddp_backward_packed_wide.cuh).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas at those shapes (stage-DMA mode: _backward_pallas_call
// :867, stage body _riccati_stage :112 with _chol_t :49 and
// _chol_solve_t :71), as ddp_backward.cuh does at the others; its plain
// twin is nmpc_tpu_torch/kernels/ddp_backward.py::backward_stacked.  The
// wrapper (kernels/ddp_backward_fused.py) builds this header's launch for
// a wide shape and ddp_backward.cuh's for any other.
//
// What bounds it on the card: each lane's chain of N dependent stages.
// At (9, 16) a stage reads 731 field values and writes 160 gains a lane
// (91 MB at B=256, N=100, fp32: 27 us at 3.35 TB/s), but its critical
// path is the NU x NU Cholesky's 16 dependent pivots (a square root and a
// division each) and the two triangular solves' 32 dependent divisions,
// each correctly rounded (a branch to a slow path around it, which the
// compiler schedules nothing across), beside the Q expansion's and the
// value update's chains of sums: ~10 us a stage whatever the batch (one
// lane alone on the card takes nearly B=256's time; PERF.md).
//
// What the design does about it: K1's block (ddp_backward.cuh) with its
// producer warp and ring of one-stage TMA buffers, whose consumers run
// riccati_stage_wide.cuh's stage on a group of G = kRowGroup threads a
// lane (32 at (9, 16): a lane a warp), each owning rows of every
// product, so that no thread holds more than a row of a 16 x 16 matrix
// and nothing spills;
// what the group exchanges lives in each lane's scratch in the block's
// dynamic shared memory, beside the ring (WideScratch, the carry
// included).  A block holds WideK1Block::lanes(B) lanes: row_lanes<G>(B) (at
// least a warp's and 4, a TMA box row of 16 bytes at fp32) up to the
// most that keep it within 8 warps (255 registers a thread) and its ring
// of two buffers and scratch within 227 KB (max_lanes: 4 at (9, 16),
// G = 32; 8 at G = 16); the ring holds as many buffers as then fit
// (ring: 8 at G = 32), checked when the unit compiles; one kernel
// for each lane count, so that every field's address in the ring is an
// immediate offset.  Every field lands at a 128-byte boundary of the block's lanes
// (WideRingLayout pads by the fewest lanes a block holds).  As in K1, a
// lane past the batch's end runs the last lane's column and stores
// nothing, and a warp wholly past it returns at once.

#pragma once

#include <type_traits>

#include "ddp_backward.cuh"
#include "riccati_stage_wide.cuh"

namespace nmpc {

// The fewest lanes of a wide block: a warp's, and 4 (TMA takes a box row
// of at least 16 bytes).
template <int G>
__host__ __device__ constexpr int wide_min_lanes() {
  return (32 / G) > 4 ? 32 / G : 4;
}

// Field offsets of the ring's buffers: each field's offset a multiple of
// the values that make 128 bytes over the fewest lanes (fp32: 8, fp64:
// 4 at G >= 8), so every field lands 128-byte aligned at any lane count
// the block takes (a multiple of wide_min_lanes).
template <typename T, int G>
__host__ __device__ constexpr int wide_stage_align() {
  return wide_min_lanes<G>() * static_cast<int>(sizeof(T)) >= 128
             ? 1
             : 128 / (wide_min_lanes<G>() * static_cast<int>(sizeof(T)));
}
template <typename T, int NX, int NU, int G>
using WideRingLayout = StageLayout<NX, NU, wide_stage_align<T, G>()>;

// The most threads of a wide block, the producer warp's included: 8
// warps, so that ptxas keeps 255 registers a thread (it sizes a block's
// registers by 4 warps at a time: 9 warps would leave 168).
constexpr int kWideMaxThreads = 256;

// The size rules of a wide block of G threads a lane, whose ring
// buffers hold F values a lane and whose lanes' scratch S values each,
// with X bytes more after the scratch: a host-and-device rule, so that
// the launch and the kernel compute it alike.
template <typename T, int G, int F, int S, size_t X = 0>
struct WideBlock {
  // values between two lanes' scratch: S rounded up to 128 bytes, plus G
  // values (modulo 128 bytes), so that the lanes of a warp reading the
  // same value hit distinct banks
  static constexpr int per = 128 / static_cast<int>(sizeof(T));
  static constexpr int stride = (S + per - 1) / per * per + G % per;

  // bytes of a block of L lanes with a ring of R buffers: the ring, then
  // the lanes' scratch, then the X bytes
  __host__ __device__ static constexpr size_t bytes(int R, int L) {
    return ring_bytes<T>(R, 1, F, L) +
           static_cast<size_t>(L) * stride * sizeof(T) + X;
  }

  // the most lanes of a block: kMaxRowLanes, halved while the block
  // passes kWideMaxThreads or a ring of two buffers and the rest pass a
  // block's shared memory (not below wide_min_lanes; ring() then holds
  // one buffer)
  __host__ __device__ static constexpr int max_lanes() {
    int L = kMaxRowLanes;
    while (L > wide_min_lanes<G>() &&
           (L * G + 32 > kWideMaxThreads || bytes(2, L) > kMaxBlockSmem))
      L /= 2;
    return L;
  }

  // buffers of the ring: as many as fit beside max_lanes() lanes, at most
  // kMaxStageRing
  __host__ __device__ static constexpr int ring() {
    int R = kMaxStageRing;
    while (R > 1 && bytes(R, max_lanes()) > kMaxBlockSmem) --R;
    return R;
  }

  // lanes of a block for a batch of B lanes
  __host__ __device__ static int lanes(int B) {
    const int L = row_lanes<G>(B);
    return L < max_lanes() ? L : max_lanes();
  }
};

// K1-wide's block: the ring's buffers in WideRingLayout, WideScratch a
// lane (at (9, 16), G = 32: at most 4 lanes, a ring of 8 buffers).
template <typename T, int NX, int NU, int G>
using WideK1Block = WideBlock<T, G, WideRingLayout<T, NX, NU, G>::F,
                              WideScratch<NX, NU>::size>;

// K2 and K3 at the wide shapes (ddp_backward_chunked_wide.cuh, BOX = 1;
// ddp_backward_packed_wide.cuh, BOX = kWideBoxRows): K1-wide's lanes and
// scratch a lane (One: a block whose two buffers hold one stage each,
// whose lanes are the most the block takes), two buffers of C stages of
// the packed layout (row_group.cuh::wide_chunk_stages: 9 and 8 at (9, 16)
// fp32, 4 and 3 at fp64), checked when the unit compiles.
template <typename T, int NX, int NU, int G, int BOX>
struct WideChunkBlock {
  static constexpr int F = PackedLayout<NX, NU>::F;
  using One = WideBlock<T, G, wide_chunk_rows(1, F, BOX),
                        WideScratch<NX, NU>::size>;
  static constexpr int lanes = One::max_lanes();
  static constexpr size_t scratch = One::stride * sizeof(T);
  static constexpr int chunk = wide_chunk_stages<T>(F, BOX, lanes, scratch);
  static_assert(wide_chunk_bytes<T>(chunk, F, BOX, lanes, scratch) <=
                    kMaxBlockSmem,
                "a wide block's two buffers of a stage and its scratch pass "
                "its shared memory");

  // bytes of a block of L lanes with buffers of C stages
  __host__ __device__ static constexpr size_t bytes(int C, int L) {
    return wide_chunk_bytes<T>(C, F, BOX, L, scratch);
  }
};

// launch(std::integral_constant<int, L>()) at L == lanes, L one of the
// lane counts a wide block takes (wide_min_lanes<G>() doubled up to
// MOST); cudaErrorInvalidValue at any other.
template <int L, int MOST, typename Launch>
int with_lanes(int lanes, const Launch& launch) {
  if constexpr (L > MOST) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (lanes != L) return with_lanes<2 * L, MOST>(lanes, launch);
    return launch(std::integral_constant<int, L>());
  }
}

// The recursion of one lane's group: the terminal carry into the lane's
// scratch `s`, then the chunks of C stages from the end of the horizon
// (row_group.cuh::packed_chunk; `feed.acquire(c)` gives this lane's
// column of chunk c, stage i at (i - start) Layout::F values of L lanes),
// each stage's gains (k and K, row by row as s[X] holds them) stored by
// the group (value q by rank q % G), and dV and ok by rank 0.  K1-wide's
// ring feeds one stage a chunk (C = 1), K2's and K3's C.
template <typename T, int NX, int NU, int G, int L, typename Layout,
          typename Feed>
__device__ __forceinline__ void wide_backward(
    Feed& feed, const GroupLane<G>& at, int N, int C, int B, int reg_type,
    const T* __restrict__ VxT, const T* __restrict__ VxxT,
    const T* __restrict__ lam_in, const BackwardOut<T>& out, T* s) {
  using S = WideScratch<NX, NU>;
  const int r = LaneGroup<G>::rank();
  for (int e = r; e < NX + NX * NX; e += G)   // Vx, then Vxx, at S::Vx
    s[S::Vx + e] = e < NX ? VxT[static_cast<size_t>(e) * B + at.b]
                          : VxxT[static_cast<size_t>(e - NX) * B + at.b];
  __syncwarp();
  const T lam = lam_in[at.b];
  T dV0 = T(0), dV1 = T(0);
  bool ok = true;
  const int n = packed_chunks(N, C);
  for (int c = 0; c < n; ++c) {
    const T* slab = feed.acquire(c);
    const PackedChunk chunk = packed_chunk(c, N, C);
    for (int i = chunk.hi - 1; i >= chunk.lo; --i) {
      riccati_stage_wide<T, NX, NU, G, L, Layout>(
          slab + static_cast<size_t>(i - chunk.start) * Layout::F * L, lam,
          reg_type, s, dV0, dV1, ok);
      if (at.live) {
        constexpr int EG = (NU * (NX + 1) + G - 1) / G;   // values a thread
#pragma unroll
        for (int j = 0; j < EG; ++j) {
          const int e = j * G + r;
          if (EG * G == NU * (NX + 1) || e < NU * (NX + 1)) {
            const int a = e / (NX + 1), col = e % (NX + 1);
            const T v = s[S::X + a * S::XS + col];
            if (col == 0)
              out.ks[idx2(i, a, NU, at.b, B)] = v;
            else
              out.Ks[idx3(i, a, col - 1, NU, NX, at.b, B)] = v;
          }
        }
      }
      // the next stage of the chunk writes s[X] before its first barrier
      // (the next chunk's acquire meets the warp itself)
      if (i > chunk.lo) __syncwarp();
    }
  }
  if (at.live && r == 0) {
    out.dV[at.b] = dV0;
    out.dV[static_cast<size_t>(B) + at.b] = dV1;
    out.ok[at.b] = ok ? 1 : 0;
  }
}

// A block: L lanes of G threads (the consumer warps), then one producer
// warp filling K1's ring (ddp_backward.cuh) from the end of the horizon;
// the lanes' scratch after the ring.  One kernel for each L a launch
// takes (WideK1Block::lanes), so that the slab's lane stride is a constant.
template <typename T, int NX, int NU, int G, int L>
__global__ void __launch_bounds__(L * G + 32)
ddp_backward_wide_kernel(const __grid_constant__ FieldMaps maps,
                         const T* __restrict__ VxT,
                         const T* __restrict__ VxxT,
                         const T* __restrict__ lam_in, BackwardOut<T> out,
                         int N, int B, int reg_type) {
  using Layout = WideRingLayout<T, NX, NU, G>;
  constexpr int W = 32 / G;
  constexpr int R = WideK1Block<T, NX, NU, G>::ring();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const StageRing<T, R> ring(smem_raw, packed_buffer_bytes<T>(1, Layout::F,
                                                              L));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], (lanes + W - 1) / W);   // warps with lanes
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= L * G) {       // the producer warp
    if (threadIdx.x % 32 != 0) return;
    auto load = [&maps, base, N](int c, T* dst, uint64_t* bar) {
      constexpr int offset[7] = {Layout::Fx, Layout::Fu, Layout::Lx,
                                 Layout::Lu, Layout::Lxx, Layout::Luu,
                                 Layout::Lxu};
      mbar_arm(bar, static_cast<uint32_t>(PackedLayout<NX, NU>::F * L *
                                          sizeof(T)));
#pragma unroll
      for (int f = 0; f < 7; ++f)
        tma_load_3d(maps.field[f], bar, dst + offset[f] * L, base, 0,
                    N - 1 - c);
    };
    ring.produce(N, load);
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  T* scratch = reinterpret_cast<T*>(
      smem_raw + ring_bytes<T>(R, 1, Layout::F, L));
  StageRingFeed<T, R> feed{ring, at.b - base, L};
  wide_backward<T, NX, NU, G, L, Layout>(
      feed, at, N, 1, B, reg_type, VxT, VxxT, lam_in, out,
      scratch + static_cast<size_t>(threadIdx.x / G) *
                    WideK1Block<T, NX, NU, G>::stride);
}

// Launch on `stream`, with the arguments and the result of
// ddp_backward.cuh::launch_ddp_backward.
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward_wide(int N, int B, int ld, int reg_type,
                             const void* const* fields, const void* VxT,
                             const void* VxxT, const void* lam, void* ks,
                             void* Ks, void* dV, void* ok, void* stream) {
  using Block = WideK1Block<T, NX, NU, G>;
  constexpr int R = Block::ring();
  constexpr int most = Block::max_lanes();
  static_assert(Block::bytes(R, most) <= kMaxBlockSmem,
                "a wide block's ring and scratch pass its shared memory");
  static_assert(most * G + 32 <= 1024, "a wide block passes 1024 threads");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int L = Block::lanes(B);
  const int sizes[7] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU};
  FieldMaps maps;
  for (int f = 0; f < 7; ++f) {
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, sizes[f],
                                     N, ld, L, sizes[f], 1);
    if (err != 0) return err;
  }
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  return with_lanes<wide_min_lanes<G>(), most>(L, [&](auto lanes) {
    constexpr int LL = decltype(lanes)::value;
    const size_t smem = Block::bytes(R, LL);
    const int err =
        allow_dynamic_smem(ddp_backward_wide_kernel<T, NX, NU, G, LL>, smem);
    if (err != 0) return err;
    ddp_backward_wide_kernel<T, NX, NU, G, LL>
        <<<(B + LL - 1) / LL, LL * G + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
            maps, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
            static_cast<const T*>(lam), out, N, B, reg_type);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace nmpc

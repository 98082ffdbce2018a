// Fused DDP Riccati backward pass for Hopper (sm_90a), and the lane-group
// loop the sweep-fed kernels share.
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas (stage-DMA mode: _backward_pallas_call, kernel
// _make_kernel, stage body _riccati_stage with _chol_t/_chol_solve_t).
// Its plain twin is nmpc_tpu_torch/kernels/ddp_backward.py::
// backward_stacked; the math and the order of each sum follow
// _riccati_stage.
//
// What bounds it on the card: the latency of each lane's chain of N
// dependent stages, not device memory.  Per stage and lane it reads the
// seven derivative fields (46 values at nx=4, nu=1) and writes k and K (5
// values), ~84 MB at B=4096, N=100: 25 us at the H100's 3.35 TB/s.  One
// thread per lane took ~1.3-1.6 us a stage whether an SM held one lane or
// 32 (PERF.md): the stage's ~700 instructions issued from one warp, one
// at a time behind their dependences, while the SM's other schedulers
// idled, and 32-lane blocks left half the SMs empty at B=2048.
//
// What the design does about it:
//   * a lane is a group of G = kRowGroup threads running
//     riccati_stage.cuh::riccati_stage_group (each owns rows of the
//     NX-sized products; every value is computed by one thread in the
//     one-thread order, so every G gives the same bits, built with
//     -fmad=false), and a block holds row_lanes(B) lanes (row_group.cuh):
//     B=4096 fills 128 blocks of four consumer warps, B=2048 128 blocks
//     of two (each with its producer warp, below);
//   * one producer warp per block keeps a ring of R one-stage buffers of
//     the block's L lanes full through the Tensor Memory Accelerator, from
//     the end of the horizon: its first thread fills a buffer with seven
//     boxes, one per field (a tensor map per field over its [N, size, B]
//     array; the box is the field's values of one stage for the block's
//     lanes), landed at the field's offset of StageRingLayout (the packed
//     order with each field on a 128-byte boundary, as TMA lands a box),
//     so a stage arrives as the [F][L] slab riccati_stage_group reads,
//     lanes fastest: the group's reads are broadcasts, the lanes'
//     neighbouring words.  Each buffer has a full mbarrier, armed for the
//     stage's bytes, and an empty one, on which each consumer warp arrives
//     once it is done with the stage; R - 1 stages stay in flight while
//     one is computed.  The consumers issue no copy: in a first design
//     each warp's first thread issued its own warp's seven boxes a stage,
//     and that issue, repeated in every warp at every stage, kept K1 well
//     short of K3 on the card (PERF.md, Findings).  R comes from the
//     shared-memory budget
//     (row_group.cuh::stage_ring: 8 at (4, 1) and (2, 1), 2 at the
//     centroidal model's (9, 16) fp32, 1 at its fp64) and fits 227 KB
//     at every (NX <= 9, NU <= 16), checked when the unit compiles;
//   * past the narrow sizes (row_group.cuh::kWideStage: the centroidal
//     model's (9, 16), F = 731 values a stage) the NU-sized work every
//     thread of a group runs alike here (Quu, Quu_F and their Cholesky,
//     16 x 16 each; FuT Vxx, 16 x 9) passes the register file and spills
//     to local memory, so the wrapper builds ddp_backward_wide.cuh there:
//     this block and ring, with a stage that splits that work over the
//     lane's group through shared memory (riccati_stage_wide.cuh);
//   * TMA takes a field at a 16-byte aligned address with its lanes a
//     multiple of 16 bytes apart: the wrapper copies any other field (B =
//     1023 at fp32, a view at an offset) once into a padded buffer
//     (kernels/ddp_backward_fused.py::tma_fields, counted); lanes past B
//     arrive zero-filled, a group past the batch's end reads the last
//     lane's column and stores nothing, and a warp wholly past it returns
//     at once.
// The loop over the chunks (group_backward) is K2's (ddp_backward_
// chunked.cuh, cp.async chunks) and K3's (ddp_backward_packed.cuh, TMA
// chunks of the packed buffer) too: the three kernels differ only in how
// a stage reaches shared memory (a feed: StageRingFeed here, CpAsyncFeed
// and TmaRingFeed in K2's and K3's headers).

#pragma once

#include "cp_async.cuh"
#include "remat_common.cuh"
#include "riccati_stage.cuh"
#include "row_group.cuh"
#include "tma.cuh"

namespace nmpc {

// The terminal carry (Vx_T, Vxx_T, dV = 0, ok) of lane b.
template <typename T, int NX>
__device__ __forceinline__ void init_carry(const T* __restrict__ VxT,
                                           const T* __restrict__ VxxT, int b,
                                           int B, Carry<T, NX>& carry) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    carry.Vx[a] = VxT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      carry.Vxx[a][e] = VxxT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  carry.dV0 = T(0);
  carry.dV1 = T(0);
  carry.ok = true;
}

template <typename T, int NX>
__device__ __forceinline__ void store_result(const Carry<T, NX>& carry, int b,
                                             int B, T* __restrict__ dV,
                                             unsigned char* __restrict__ ok) {
  dV[b] = carry.dV0;
  dV[static_cast<size_t>(B) + b] = carry.dV1;
  ok[b] = carry.ok ? 1 : 0;
}

// This thread's place in a block of L lanes: its warp, the warp's first
// lane, its own lane (past B: the last lane's data, stored nowhere).
template <int G>
struct GroupLane {
  int warp, lane0, b;
  bool live;
  __device__ GroupLane(int B, int L)
      : warp(static_cast<int>(threadIdx.x) / 32),
        lane0(static_cast<int>(blockIdx.x) * L + warp * (32 / G)) {
    const int lane = lane0 + static_cast<int>(threadIdx.x % 32) / G;
    live = lane < B;
    b = live ? lane : B - 1;
  }
  __device__ bool leader() const { return threadIdx.x % 32 == 0; }
};

// The outputs of the unboxed backward.
template <typename T>
struct BackwardOut {
  T* __restrict__ ks;
  T* __restrict__ Ks;
  T* __restrict__ dV;
  unsigned char* __restrict__ ok;
};

// The recursion of one lane's group over chunks of C stages from the end
// of the horizon (row_group.cuh::packed_chunk): `feed.acquire(c)` makes
// chunk c readable by the whole warp and returns this lane's column of
// its buffer (stage i at (i - start) Layout::F values of feed.stride
// lanes); each stage runs riccati_stage_group and its gains are stored;
// rank 0 stores dV and ok.  Every thread of a warp calls it (a warp
// wholly past the batch has returned).
template <typename T, int NX, int NU, int G, typename Layout, typename Feed>
__device__ __forceinline__ void group_backward(
    Feed& feed, const GroupLane<G>& at, int N, int C, int B, int reg_type,
    const T* __restrict__ VxT, const T* __restrict__ VxxT,
    const T* __restrict__ lam_in, const BackwardOut<T>& out) {
  Carry<T, NX> carry;
  init_carry<T, NX>(VxT, VxxT, at.b, B, carry);
  const T lam = lam_in[at.b];
  const int n = packed_chunks(N, C);
  for (int c = 0; c < n; ++c) {
    const T* slab = feed.acquire(c);
    const PackedChunk chunk = packed_chunk(c, N, C);
    for (int i = chunk.hi - 1; i >= chunk.lo; --i) {
      T k[NU], K[NU][NX];
      riccati_stage_group<T, NX, NU, G, Layout>(
          slab + static_cast<size_t>(i - chunk.start) * Layout::F *
                     feed.stride,
          feed.stride, lam, reg_type, carry, k, K);
      if (at.live)
        store_gains_group<T, NX, NU, G>(k, K, i, at.b, B, out.ks, out.Ks);
    }
  }
  if (at.live && LaneGroup<G>::rank() == 0)
    store_result<T, NX>(carry, at.b, B, out.dV, out.ok);
}

// K1's ring: R one-stage buffers ([F][L]: L, the block's lanes, a value)
// after a full and an empty mbarrier per buffer (the first 128 bytes).
// The producer's first thread waits until every consumer warp left a
// buffer, arms its full barrier and issues its seven boxes; a consumer
// warp waits on the full barrier and, done with the stage, meets and
// arrives once on the empty barrier (row_group.cuh: stage c in buffer c %
// R, its (c / R)-th use).
template <typename T, int R>
struct StageRing {
  static_assert(R >= 1 && R * 16 <= 128, "a ring's barriers take 128 bytes");
  uint64_t* full;
  uint64_t* empty;
  T* buffers;
  size_t buffer;

  __device__ StageRing(unsigned char* smem, size_t buffer_bytes)
      : full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + R),
        buffers(reinterpret_cast<T*>(smem + 128)),
        buffer(buffer_bytes / sizeof(T)) {}

  // the producer's first thread: every stage, from the end of the horizon
  template <typename Load>
  __device__ void produce(int N, const Load& load) const {
    for (int c = 0; c < N; ++c) {
      const int s = c % R;
      if (c >= R) mbar_wait(&empty[s], static_cast<uint32_t>((c / R - 1) & 1));
      load(c, buffers + s * buffer, &full[s]);
    }
  }
};

// A consumer warp's side of K1's ring, this lane's column at `col`.
template <typename T, int R>
struct StageRingFeed {
  const StageRing<T, R>& ring;
  int col, stride;

  __device__ const T* acquire(int c) {
    if (c > 0) {
      // the warp is done with stage c - 1
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&ring.empty[(c - 1) % R]);
    }
    mbar_wait(&ring.full[c % R], static_cast<uint32_t>((c / R) & 1));
    return ring.buffers + (c % R) * ring.buffer + col;
  }
};

// K1's tensor maps, one per field ([N, size, B]: Fx, Fu, Lx, Lu, Lxx,
// Luu, Lxu).
struct FieldMaps {
  CUtensorMap field[7];
};

// A block: L lanes of G threads (the consumer warps), then one producer
// warp.
template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kMaxRowLanes * G + 32)
ddp_backward_kernel(const __grid_constant__ FieldMaps maps,
                    const T* __restrict__ VxT, const T* __restrict__ VxxT,
                    const T* __restrict__ lam_in, BackwardOut<T> out, int N,
                    int B, int reg_type) {
  using Layout = StageRingLayout<T, NX, NU, G>;
  constexpr int W = 32 / G;
  constexpr int R = stage_ring<T>(Layout::F);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = (static_cast<int>(blockDim.x) - 32) / G;
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
    auto load = [&maps, base, L, N](int c, T* dst, uint64_t* bar) {
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
  StageRingFeed<T, R> feed{ring, at.b - base, L};
  group_backward<T, NX, NU, G, Layout>(feed, at, N, 1, B, reg_type, VxT,
                                       VxxT, lam_in, out);
}

// Launch on `stream`; returns a CUDA error code: of a field's tensor map
// (tma.cuh::encode_map_3d), of the shared-memory attribute, or
// cudaGetLastError() after the launch.  fields: Fx, Fu, Lx, Lu, Lxx, Luu,
// Lxu, each batch-minor [N, size, B] with its lanes ld values apart (ld *
// sizeof(T) and each address multiples of 16 bytes); VxT [NX, B], VxxT
// [NX, NX, B], lam [B] contiguous; ok is one byte per lane.
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward(int N, int B, int ld, int reg_type,
                        const void* const* fields, const void* VxT,
                        const void* VxxT, const void* lam, void* ks, void* Ks,
                        void* dV, void* ok, void* stream) {
  using Layout = StageRingLayout<T, NX, NU, G>;
  constexpr int R = stage_ring<T>(Layout::F);
  static_assert(ring_bytes<T>(R, 1, Layout::F, kMaxRowLanes) <=
                    kMaxBlockSmem,
                "a block's ring of one-stage buffers passes its shared memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int L = row_lanes<G>(B);
  const int sizes[7] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU};
  FieldMaps maps;
  for (int f = 0; f < 7; ++f) {
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, sizes[f],
                                     N, ld, L, sizes[f], 1);
    if (err != 0) return err;
  }
  const size_t smem = ring_bytes<T>(R, 1, Layout::F, L);
  const int err = allow_dynamic_smem(ddp_backward_kernel<T, NX, NU, G>, smem);
  if (err != 0) return err;
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  ddp_backward_kernel<T, NX, NU, G><<<(B + L - 1) / L, L * G + 32, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), out, N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

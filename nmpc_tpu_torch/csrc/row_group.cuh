// The lane-group geometry of the unboxed DDP backward kernels that run
// riccati_stage.cuh::riccati_stage_group: the packed backward (K3,
// ddp_backward_packed.cuh) and the unboxed remat backward (K5,
// ddp_backward_remat.cuh).  A block holds L lanes of G threads each
// (thread t is rank t % G of the block's lane t / G); the groups of a warp
// exchange rows by whole-warp shuffles, so a block is a whole number of
// warps and a lane past the batch's end runs the last lane's data and
// stores nothing.  Also here: what each kernel keeps in shared memory per
// warp (K3's ring of TMA chunk buffers, K5's field slab), so that every
// launch stays within a block's shared memory, and K3's chunk schedule.
// Every size rule is a host-and-device function, so the launch and the
// kernel compute it alike.

#pragma once

#include "remat_common.cuh"
#include "riccati_stage.cuh"

namespace nmpc {

// Threads per lane of riccati_stage_group at (NX, NU), chosen by
// measurement on the H100 among 1, 2, 4, 8 at (4, 1) and 1, 2 at (2, 1)
// (PERF.md, Findings): K3 (kRowGroup) is fastest at 4 and 2 (8 at (4, 1)
// is slower: the ranks past NX idle on the split work); K5 (kRematGroup)
// at 8, where each thread generates the fields of one stage in eight,
// level with 4 at B=4096 and faster at B=256.  Other (NX, NU) follow the
// nearest measured shape: nx >= 4 as (4, 1), nx = 2, 3 as (2, 1), nx = 1
// one thread.
template <int NX, int NU>
constexpr int kRowGroup = NX >= 4 ? 4 : (NX >= 2 ? 2 : 1);
template <int NX, int NU>
constexpr int kRematGroup = NX >= 4 ? 8 : kRowGroup<NX, NU>;

// The most lanes of a block, and the block count a launch aims for: about
// one block per SM of the H100's 132.
constexpr int kMaxRowLanes = 32;
constexpr int kFillBlocks = 128;

// The most dynamic shared memory a block can hold on the H100 (opted in
// above 48 KB by cp_async.cuh::allow_dynamic_smem).
constexpr size_t kMaxBlockSmem = 227 * 1024;

// Lanes per block for a batch of B lanes: 32, halved while the batch
// fills fewer than kFillBlocks blocks, down to the whole warp (32 / G
// lanes) and to 4 lanes (a TMA box row of 16 bytes at fp32).  B = 4096:
// 32; B = 2048: 16 (128 blocks instead of 64); B = 256 at G = 4: 8.
template <int G>
__host__ __device__ inline int row_lanes(int B) {
  const int least = (32 / G) > 4 ? 32 / G : 4;
  int L = kMaxRowLanes;
  while (L > least && (B + L - 1) / L < kFillBlocks) L /= 2;
  return L;
}

// K3: each warp's ring of kPackedRing chunk buffers of C stages; C as many
// stages as the rings of a 32-lane block hold within kPackedBudget, at
// most kMaxPackedChunk.
constexpr int kPackedRing = 4;
constexpr size_t kPackedBudget = 96 * 1024;
constexpr int kMaxPackedChunk = 32;

// Bytes of one chunk buffer: C stages of F values of L lanes, rounded up to
// 128 bytes so that every buffer of the ring stays aligned for TMA.
template <typename T>
__host__ __device__ constexpr size_t packed_buffer_bytes(int C, int F,
                                                         int L) {
  return (static_cast<size_t>(C) * F * L * sizeof(T) + 127) / 128 * 128;
}

// Bytes of one warp's part of the block's shared memory: its kPackedRing
// barriers (in the first 128 bytes) and chunk buffers of C stages of W
// lanes.
template <typename T>
__host__ __device__ constexpr size_t packed_warp_bytes(int C, int F, int W) {
  return 128 + kPackedRing * packed_buffer_bytes<T>(C, F, W);
}

// K3's stages per chunk for F values a stage and a horizon of N: (4, 1)
// fp32 4, fp64 2; (2, 1) fp32 12, fp64 6; at least 1, at most N.
template <typename T>
__host__ __device__ constexpr int packed_chunk_stages(int F, int N) {
  const size_t per_stage = static_cast<size_t>(kPackedRing) * F *
                           kMaxRowLanes * sizeof(T);
  const int fit = static_cast<int>(kPackedBudget / per_stage);
  const int C = fit < kMaxPackedChunk ? fit : kMaxPackedChunk;
  return C < 1 ? 1 : (C < N ? C : N);
}

// K3's chunks, from the end of the horizon: chunk c of a horizon of N in
// chunks of C is the box of C stages at `start` = N - (c + 1) C, which the
// tensor map's bounds cut to stages lo = max(0, start) .. hi - 1 = N - c C
// - 1 (a last chunk that starts below 0 arrives zero-filled in front).
struct PackedChunk {
  int start, lo, hi;
};
__host__ __device__ constexpr int packed_chunks(int N, int C) {
  return (N + C - 1) / C;
}
__host__ __device__ constexpr PackedChunk packed_chunk(int c, int N, int C) {
  return {N - (c + 1) * C, N - (c + 1) * C > 0 ? N - (c + 1) * C : 0,
          N - c * C};
}

// K5: values between two stages of a warp's field slab, F W (W = 32 / G
// lanes of a warp), padded so that stage r of the warp's lane j starts on
// bank (r W + j) mod 32: the G writers of a lane, one stage each, then
// hit distinct banks.
template <int G>
__host__ __device__ constexpr int slab_stage_stride(int F) {
  return F * (32 / G) + (((32 / G) - F * (32 / G)) % 32 + 32) % 32;
}

// Bytes of one warp's slab, G stages of F values of its 32 / G lanes
// (about 32 F sizeof(T) at any G), and how many warps' slabs a block
// holds: 0 where not even one warp's fits (F >= 906 at fp64, 1810 at
// fp32).
template <typename T, int G>
__host__ __device__ constexpr size_t slab_warp_bytes(int F) {
  return static_cast<size_t>(G) * slab_stage_stride<G>(F) * sizeof(T);
}
template <typename T, int G>
__host__ __device__ constexpr int slab_warps(int F) {
  return static_cast<int>(kMaxBlockSmem / slab_warp_bytes<T, G>(F));
}

// K5's threads per lane at (T, NX, NU): kRematGroup where a warp's slab
// fits a block, else 0, one thread per lane with the stage's fields in
// registers.
template <typename T, int NX, int NU>
constexpr int kRematLaneGroup =
    slab_warps<T, kRematGroup<NX, NU>>(PackedLayout<NX, NU>::F) > 0
        ? kRematGroup<NX, NU>
        : 0;

// K5's lanes per block at G threads per lane (G = 0: one thread and no
// slab): row_lanes, halved while the block's slabs pass kMaxBlockSmem.
// At (4, 1) always row_lanes; at (8, 1) fp64 (F = 154, G = 8) at most 20
// lanes of slab, so 16.
template <typename T, int G>
__host__ __device__ inline int remat_lanes(int F, int B) {
  if (G == 0) return row_lanes<1>(B);
  constexpr int GT = G > 0 ? G : 1;
  int L = row_lanes<GT>(B);
  while (L > 32 / GT && L / (32 / GT) > slab_warps<T, GT>(F)) L /= 2;
  return L;
}

// Bytes of K5's slabs in a block of L lanes (0 at G = 0).
template <typename T, int G>
__host__ __device__ constexpr size_t remat_smem_bytes(int F, int L) {
  return G == 0 ? 0
                : static_cast<size_t>(L / (32 / (G > 0 ? G : 1))) *
                      slab_warp_bytes<T, (G > 0 ? G : 1)>(F);
}

// Store stage i's k and K of lane b: the G threads of the group split the
// NU + NU NX values (value q by rank q % G).
template <typename T, int NX, int NU, int G>
__device__ __forceinline__ void store_gains_group(const T (&k)[NU],
                                                  const T (&K)[NU][NX],
                                                  int i, int b, int B,
                                                  T* __restrict__ ks,
                                                  T* __restrict__ Ks) {
  const int r = LaneGroup<G>::rank();
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    if (a % G == r) ks[idx2(i, a, NU, b, B)] = k[a];
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      if ((NU + a * NX + e) % G == r)
        Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
    }
  }
}

}  // namespace nmpc

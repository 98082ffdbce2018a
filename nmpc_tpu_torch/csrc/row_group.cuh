// The lane-group geometry of the unboxed DDP backward kernels that run
// riccati_stage.cuh::riccati_stage_group: the sweep-fed backward (K1,
// ddp_backward.cuh), the chunked (K2, ddp_backward_chunked.cuh) and
// packed (K3, ddp_backward_packed.cuh) ones and the unboxed remat backward
// (K5, ddp_backward_remat.cuh).  A block holds L lanes of G threads each
// (thread t is rank t % G of the block's lane t / G); the groups of a warp
// exchange rows by whole-warp shuffles, so a block is a whole number of
// warps and a lane past the batch's end runs the last lane's data and
// stores nothing.  Also here: what each kernel keeps in shared memory per
// block or warp (K1's block ring of one-stage TMA buffers, K2's two
// cp.async chunk slots a warp, K3's ring of TMA chunk buffers a warp, K5's
// field slab a warp; K2's and K3's two chunk buffers at the wide shapes),
// so that every launch stays within a block's shared memory, and the
// chunk schedule K1, K2 and K3 share.  Every size rule is
// a host-and-device function, so the launch and the kernel compute it
// alike.

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
// one thread.  Past those narrow sizes (kWideStage: nx > 8 or nu > 4,
// the centroidal model's (9, 16)) K1, K2 and K3 run riccati_stage_wide.
// cuh's stage on kWideGroup threads a lane, chosen by measurement among
// 8, 16 and 32 at (9, 16) for K1 (PERF.md, Findings).
template <int NX, int NU>
constexpr bool kWideStage = NX > 8 || NU > 4;
constexpr int kWideGroup = 32;
template <int NX, int NU>
constexpr int kRowGroup =
    kWideStage<NX, NU> ? kWideGroup : (NX >= 4 ? 4 : (NX >= 2 ? 2 : 1));
template <int NX, int NU>
constexpr int kRematGroup = NX >= 4 ? 8 : (NX >= 2 ? 2 : 1);

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

// The stage buffers of K1, K2 and K3 take at most kStageBudget bytes in a
// 32-lane block (more only where one stage a buffer passes it): how many
// stages of F values fit it `copies` times over, at least 1, at most
// `most`.
constexpr size_t kStageBudget = 96 * 1024;

template <typename T>
__host__ __device__ constexpr int stages_within(int copies, int F,
                                                int most) {
  const int fit = static_cast<int>(
      kStageBudget /
      (static_cast<size_t>(copies) * F * kMaxRowLanes * sizeof(T)));
  return fit < 1 ? 1 : (fit < most ? fit : most);
}

// Bytes of one chunk buffer: C stages of F values of L lanes, rounded up to
// 128 bytes so that every buffer of a ring stays aligned for TMA.
template <typename T>
__host__ __device__ constexpr size_t packed_buffer_bytes(int C, int F,
                                                         int L) {
  return (static_cast<size_t>(C) * F * L * sizeof(T) + 127) / 128 * 128;
}

// Bytes of a ring in the block's shared memory (K1's, the block's; K3's,
// each warp's): its barriers (in the first 128 bytes) and R chunk buffers
// of C stages of F values of `lanes` lanes.
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int R, int C, int F,
                                                int lanes) {
  return 128 + R * packed_buffer_bytes<T>(C, F, lanes);
}

// K1: each block's ring of one-stage buffers, each filled by seven TMA
// boxes (one per field).  A box lands only at a 128-byte aligned address
// and a field's value of the block's L lanes takes L sizeof(T) bytes, L a
// multiple of a warp's W = 32 / G lanes (row_lanes), so each field's
// offset is rounded up to a multiple of stage_align = 128 / (W sizeof(T))
// values (StageRingLayout: (4, 1) fp32 at G = 4, F = 46 -> 52; (2, 1)
// fp32 at G = 2, 16 -> 18; G = 1 at fp32, and fp64 at G <= 2,
// unpadded).  The ring holds as many buffers as fit kStageBudget, at most
// kMaxStageRing, and at least 2 where two fit a block's shared memory: 8
// at (4, 1) and (2, 1); 2 at (8, 4) fp64 (F = 220), 110 KB a block, and
// at (9, 16) fp32 (F = 740), 185 KB; one at (9, 16) fp64 (F = 734), 184
// KB, where the producer refills the buffer only once the consumers left
// it (no stage in flight while one is computed).
constexpr int kMaxStageRing = 8;

template <typename T, int G>
__host__ __device__ constexpr int stage_align() {
  return (32 / G) * static_cast<int>(sizeof(T)) >= 128
             ? 1
             : 128 / ((32 / G) * static_cast<int>(sizeof(T)));
}
template <typename T, int NX, int NU, int G>
using StageRingLayout = StageLayout<NX, NU, stage_align<T, G>()>;

template <typename T>
__host__ __device__ constexpr int stage_ring(int F) {
  const int R = stages_within<T>(1, F, kMaxStageRing);
  if (R >= 2) return R;
  return ring_bytes<T>(2, 1, F, kMaxRowLanes) <= kMaxBlockSmem ? 2 : 1;
}

// K2: each warp's two slots of C stages (cp.async, double-buffered by
// chunk), packed order, no padding; C as many stages as the two slots fit
// kStageBudget, at most kMaxChunk and N: (4, 1) fp32 8, fp64 4; (2, 1)
// fp32 24, fp64 12; (8, 4) fp64 1 (110 KB a block).  kernels/
// ddp_backward_fused.py::chunk_stages mirrors it.
constexpr int kMaxChunk = 32;

template <typename T>
__host__ __device__ constexpr int chunked_chunk_stages(int F, int N) {
  const int C = stages_within<T>(2, F, kMaxChunk);
  return C < N ? C : N;
}

// Bytes of one warp's two K2 slots of C stages of F values of W lanes.
template <typename T>
__host__ __device__ constexpr size_t chunked_warp_bytes(int C, int F, int W) {
  return 2 * static_cast<size_t>(C) * F * W * sizeof(T);
}

// K3: each warp's ring of kPackedRing chunk buffers of C stages; C as many
// stages as the rings fit kStageBudget, at most kMaxChunk and N: (4, 1)
// fp32 4, fp64 2; (2, 1) fp32 12, fp64 6.
constexpr int kPackedRing = 4;

template <typename T>
__host__ __device__ constexpr int packed_chunk_stages(int F, int N) {
  const int C = stages_within<T>(kPackedRing, F, kMaxChunk);
  return C < N ? C : N;
}

// K2 and K3 at the wide shapes (kWideStage: ddp_backward_chunked_wide.cuh,
// ddp_backward_packed_wide.cuh): a block of `lanes` lanes (K1-wide's,
// ddp_backward_wide.cuh::WideBlock: 4 at (9, 16)) holds two buffers of C
// stages after 128 bytes of barriers (K3's ring; K2 leaves them unused),
// then each lane's scratch (`scratch` bytes a lane).  A buffer holds C F
// values a lane, rounded up to a whole number of `box` rows (K3: its TMA
// boxes of kWideBoxRows rows of the packed buffer; K2: box = 1), and its
// bytes to 128.  C: the most stages, at most kMaxChunk, that keep the
// block within kMaxBlockSmem, at least 1; the launch takes min(C, N).
// (9, 16): K2 9 (fp32) and 4 (fp64), K3 8 and 3.  kernels/
// ddp_backward_fused.py::chunk_stages mirrors K2's.
constexpr int kWideBoxRows = 256;

__host__ __device__ constexpr int wide_chunk_rows(int C, int F, int box) {
  return (C * F + box - 1) / box * box;
}

template <typename T>
__host__ __device__ constexpr size_t wide_chunk_bytes(int C, int F, int box,
                                                      int lanes,
                                                      size_t scratch) {
  return ring_bytes<T>(2, 1, wide_chunk_rows(C, F, box), lanes) +
         static_cast<size_t>(lanes) * scratch;
}

template <typename T>
__host__ __device__ constexpr int wide_chunk_stages(int F, int box,
                                                    int lanes,
                                                    size_t scratch) {
  int C = kMaxChunk;
  while (C > 1 && wide_chunk_bytes<T>(C, F, box, lanes, scratch) >
                      kMaxBlockSmem)
    --C;
  return C;
}

// The chunks of K1 (C = 1), K2 and K3, from the end of the horizon: chunk
// c of a horizon of N in chunks of C is the C stages from `start` = N -
// (c + 1) C, of which stages lo = max(0, start) .. hi - 1 = N - c C - 1
// exist; stage i sits at position i - start of its chunk's buffer (K3's
// tensor map fills the positions below 0 with zeros, K2 leaves them
// unset).  In a ring of R buffers chunk c takes buffer c % R in its (c /
// R)-th use, the parity its barrier's wait names; the first R chunks are
// issued at once, chunk c + R once every consumer is done with chunk c.
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

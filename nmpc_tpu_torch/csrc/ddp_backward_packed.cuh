// Packed-input DDP Riccati backward for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_packed (kernel _make_kernel_packed): K1's
// recursion (ddp_backward.cuh) with every stage's seven derivative fields
// read from one packed [N, F, B] buffer, field order and offsets of
// _field_offsets (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, each row-major; F = 46 at
// (nx, nu) = (4, 1), 16 at (2, 1)).  The wrapper builds the buffer with
// kernels/ddp_backward_fused.py::pack_derivs; its plain version unpacks
// it and runs backward_stacked.
//
// What bounds it on the card: not bytes but the latency of each lane's
// chain of N dependent stages.  At (4, 1), fp32, one thread per lane takes
// ~1.34 us a stage (~2,650 cycles at 1980 MHz) whether the batch puts one
// lane or 32 on an SM (B = 132 or 4096; PERF.md): the stage's ~700
// instructions issue from one warp, one at a time behind their
// dependences, while the SM's other schedulers idle; K1 reads 83.9 MB at
// B=4096 and K5 16.8 MB in about the same time.  At the bipedal shape
// (B=2048) 64 one-warp blocks left half of the 132 SMs idle too.  With a
// shorter stage, bytes count again: ~5.9 KB per 32 lanes and stage must
// arrive in time, more than one stage of register prefetch keeps in
// flight.
//
// What the design does about it:
//   * a lane is a group of G = kRowGroup threads running
//     riccati_stage.cuh::riccati_stage_group in ddp_backward.cuh::
//     group_backward, the loop K1 and K2 run, so the result equals K1's
//     bit for bit (all built with -fmad=false); a block holds
//     row_lanes(B) lanes (row_group.cuh);
//   * the buffer is read by the Tensor Memory Accelerator, each warp on its
//     own: the warp's first thread loads boxes of C stages x F values x W
//     lanes (W = 32 / G, the warp's lanes; [C][F][W] in shared memory, lane
//     fastest) into the warp's ring of kPackedRing buffers, each with its
//     own mbarrier (TmaRingFeed), so kPackedRing - 1
//     chunks are in flight while one is computed.  Chunks run from the end
//     of the horizon (row_group.cuh::packed_chunk: the box at stage N - (c
//     + 1) C, which the tensor map's bounds cut to stages max(0, N - (c +
//     1) C) .. N - c C - 1; a last chunk that starts below 0 arrives
//     zero-filled in front).  The launch chooses C from the shared-memory
//     budget (row_group.cuh::packed_chunk_stages), and a block's rings of
//     one-stage chunks fit 227 KB at every (NX <= 8, NU <= 4), checked
//     when the unit compiles;
//   * TMA takes a lane stride (ld values) that is a multiple of 16 bytes:
//     the wrapper copies a buffer whose B is not into one padded to such
//     an ld; the lanes past B arrive zero-filled, a group past the batch's
//     end reads the last lane's column and stores nothing, and a warp
//     wholly past it returns at once.

#pragma once

#include "ddp_backward.cuh"

namespace nmpc {

// A warp's ring of R chunk buffers of `buffer` values each (W lanes a
// value), one mbarrier per buffer (in the first 128 bytes of the warp's
// part), filled by the warp's first thread: load(c, dst, bar) arms `bar`
// and issues chunk c's boxes into `dst` (row_group.cuh: chunk c in buffer
// c % R, its (c / R)-th use; chunk c - 1 + R issued once the warp is done
// with c - 1).
template <typename T, int R, int W, typename Load>
struct TmaRingFeed {
  static_assert(R >= 1 && R * 8 <= 128, "a ring's barriers take 128 bytes");
  static constexpr int stride = W;
  uint64_t* bars;
  T* ring;
  size_t buffer;
  int n, col;
  bool leader;
  Load load;

  __device__ TmaRingFeed(unsigned char* part, size_t buffer_bytes,
                         int chunks, int column, bool is_leader, Load loader)
      : bars(reinterpret_cast<uint64_t*>(part)),
        ring(reinterpret_cast<T*>(part + 128)),
        buffer(buffer_bytes / sizeof(T)),
        n(chunks),
        col(column),
        leader(is_leader),
        load(loader) {
    if (leader) {
#pragma unroll
      for (int s = 0; s < R; ++s) mbar_init(&bars[s]);
    }
    __syncwarp();
    if (leader) {
      for (int c = 0; c < n && c < R; ++c) load(c, ring + c * buffer, &bars[c]);
    }
  }

  __device__ const T* acquire(int c) {
    if (c > 0) {
      // the warp is done with chunk c - 1: refill its buffer
      __syncwarp();
      const int next = c - 1 + R;
      if (leader && next < n)
        load(next, ring + (next % R) * buffer, &bars[next % R]);
    }
    mbar_wait(&bars[c % R], static_cast<uint32_t>((c / R) & 1));
    return ring + (c % R) * buffer + col;
  }
};

template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kMaxRowLanes * G)
ddp_backward_packed_kernel(const __grid_constant__ CUtensorMap map,
                           const T* __restrict__ VxT,
                           const T* __restrict__ VxxT,
                           const T* __restrict__ lam_in, BackwardOut<T> out,
                           int N, int B, int C, int reg_type) {
  constexpr int F = PackedLayout<NX, NU>::F;
  constexpr int W = 32 / G;                 // lanes of a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const GroupLane<G> at(B, static_cast<int>(blockDim.x) / G);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  const int lane0 = at.lane0;
  const uint32_t bytes = static_cast<uint32_t>(C) * F * W * sizeof(T);
  auto load = [&map, lane0, N, C, bytes](int c, T* dst, uint64_t* bar) {
    mbar_arm(bar, bytes);
    tma_load_3d(map, bar, dst, lane0, 0, packed_chunk(c, N, C).start);
  };
  TmaRingFeed<T, kPackedRing, W, decltype(load)> feed(
      smem_raw + at.warp * ring_bytes<T>(kPackedRing, C, F, W),
      packed_buffer_bytes<T>(C, F, W), packed_chunks(N, C), at.b - lane0,
      at.leader(), load);
  group_backward<T, NX, NU, G, PackedLayout<NX, NU>>(
      feed, at, N, C, B, reg_type, VxT, VxxT, lam_in, out);
}

// Launch on `stream`; returns a CUDA error code: of the tensor map
// (tma.cuh::encode_map_3d), of the shared-memory attribute, or
// cudaGetLastError() after the launch.  fields[0] is the packed [N, F, B]
// buffer with its lanes ld values apart (ld * sizeof(T) and its address
// multiples of 16 bytes); the rest as K1's launch.  The chunk is
// packed_chunk_stages' C (row_group.cuh).
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward_packed(int N, int B, int ld, int reg_type,
                               const void* const* fields, const void* VxT,
                               const void* VxxT, const void* lam, void* ks,
                               void* Ks, void* dV, void* ok, void* stream) {
  constexpr int F = PackedLayout<NX, NU>::F;
  constexpr int W = 32 / G;
  static_assert((kMaxRowLanes / W) * ring_bytes<T>(kPackedRing, 1, F,
                                                        W) <=
                    kMaxBlockSmem,
                "a block's rings of one-stage chunks pass its shared memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int C = packed_chunk_stages<T>(F, N);
  const int L = row_lanes<G>(B);
  CUtensorMap map;
  int err = encode_map_3d<T>(&map, fields[0], B, F, N, ld, W, F, C);
  if (err != 0) return err;
  const size_t smem = (L / W) * ring_bytes<T>(kPackedRing, C, F, W);
  err = allow_dynamic_smem(ddp_backward_packed_kernel<T, NX, NU, G>, smem);
  if (err != 0) return err;
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  ddp_backward_packed_kernel<T, NX, NU, G>
      <<<(B + L - 1) / L, L * G, smem, static_cast<cudaStream_t>(stream)>>>(
          map, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), out, N, B, C, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

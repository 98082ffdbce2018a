// The shared-memory feed of the forward recursions for Hopper (sm_90a):
// the DDP line-search rollout (K6, ddp_forward_remat.cuh) and the FMPC
// Δx/Δu recursion (K11, fmpc_forward.cuh).
//
// Both kernels walk each lane's horizon forward in a chain of N dependent
// stages; what a stage reads besides its carry (K6: x_ref, u_ref, k, K;
// K11: A, B, x_bar, k, K) does not depend on the chain.  Where a stage's
// chain is short (K11; K6 on a step without transcendental calls), a
// one-stage prefetch into registers left each stage waiting on memory at
// one warp per SM (PERF.md, Findings).  The feed brings those fields into
// shared memory a chunk of C stages at a time, in a ring of R chunk
// buffers, so that (R - 1) C to R C stages are in flight while the chain
// runs.  One producer warp per block (the block's last) fills the block's
// ring through the Tensor Memory Accelerator, one box per field and chunk
// ([L lanes, size, C stages] of the field's [N, size, B] array, issued by
// the warp's thread f for field f), in K8's ring run forward
// (ddp_backward.cuh::StageRing: a full and an empty mbarrier per buffer,
// the consumers' StageRingFeed); the consumers issue no copy.  TMA takes
// a field at a 16-byte aligned address with its lanes a multiple of 16
// bytes apart: the wrappers copy any other field once to such a stride
// (ddp_backward_fused.py::padded_fields), as they do for K1 and K8.
// A buffer holds each field's C stages of the block's lanes together, as
// a TMA box lands them ([C][size][lanes], lanes fastest), each field's
// region on a 128-byte boundary: a lane reads its own column (the G
// threads of a lane the same word), neighbouring lanes neighbouring
// words.  The ring holds fwd_depth stages of a 32-lane block within
// kStageBudget (row_group.cuh), at most kMaxFwdDepth: R = depth / C
// buffers, at least 2, at most kMaxFwdRing; the lanes of a block are
// row_lanes, halved while the ring passes a block's shared memory
// (fwd_lanes).  Every size rule is a host-and-device function, so the
// launch and the kernel compute it alike.

#pragma once

#include "ddp_backward.cuh"

namespace nmpc {

constexpr int kMaxFwdDepth = 16;
constexpr int kMaxFwdRing = 8;

// The fields of a stage, of S... values each, in the order the kernel
// names them.
template <int... S>
struct FwdFields {
  static constexpr int NF = sizeof...(S);
  static constexpr int F = (S + ... + 0);
  __host__ __device__ static constexpr int size(int f) {
    constexpr int s[] = {S...};
    return s[f];
  }
};

// Chunk c of a horizon of N in chunks of C: stages start .. hi - 1.
struct FwdChunk {
  int start, hi;
};
__host__ __device__ constexpr int fwd_chunks(int N, int C) {
  return (N + C - 1) / C;
}
__host__ __device__ constexpr FwdChunk fwd_chunk_at(int c, int N, int C) {
  return {c * C, (c + 1) * C < N ? (c + 1) * C : N};
}

// Values of field f's region of a buffer of C stages of `lanes` lanes,
// rounded up to 128 bytes, and the offset of field f's region.
template <typename T, typename Fs>
__host__ __device__ constexpr int fwd_region_values(int f, int C,
                                                    int lanes) {
  constexpr int q = 128 / static_cast<int>(sizeof(T));
  return (Fs::size(f) * C * lanes + q - 1) / q * q;
}
template <typename T, typename Fs>
__host__ __device__ constexpr int fwd_region(int f, int C, int lanes) {
  int off = 0;
  for (int g = 0; g < f; ++g) off += fwd_region_values<T, Fs>(g, C, lanes);
  return off;
}
template <typename T, typename Fs>
__host__ __device__ constexpr size_t fwd_buffer_bytes(int C, int lanes) {
  return static_cast<size_t>(fwd_region<T, Fs>(Fs::NF, C, lanes)) *
         sizeof(T);
}

// The ring's depth in stages, its buffers at chunks of C, and the chunk a
// kernel's rule asks for (`most` stages) within half the depth.
template <typename T>
__host__ __device__ constexpr int fwd_depth(int F) {
  return stages_within<T>(1, F, kMaxFwdDepth);
}
template <typename T>
__host__ __device__ constexpr int fwd_ring(int F, int C) {
  const int R = fwd_depth<T>(F) / C;
  return R < 2 ? 2 : (R > kMaxFwdRing ? kMaxFwdRing : R);
}
template <typename T>
__host__ __device__ constexpr int fwd_chunk(int F, int most) {
  const int half = fwd_depth<T>(F) / 2;
  return half < 1 ? 1 : (half < most ? half : most);
}

// Dynamic shared memory of a block of L lanes: the ring after its
// barriers.
template <typename T, typename Fs>
__host__ __device__ constexpr size_t fwd_smem(int C, int L) {
  return 128 + fwd_ring<T>(Fs::F, C) * fwd_buffer_bytes<T, Fs>(C, L);
}

// The fewest lanes of a block: a warp's, and 4 (a box row of 16 bytes).
template <int G>
__host__ __device__ constexpr int fwd_least_lanes() {
  return (32 / G) > 4 ? 32 / G : 4;
}

// Lanes per block: row_lanes, halved while the block's rings pass
// kMaxBlockSmem, down to fwd_least_lanes.
template <typename T, typename Fs, int G>
__host__ __device__ inline int fwd_lanes(int C, int B) {
  int L = row_lanes<G>(B);
  while (L > fwd_least_lanes<G>() && fwd_smem<T, Fs>(C, L) > kMaxBlockSmem)
    L /= 2;
  return L;
}

// The fields a kernel reads: a tensor map per field ([N, size, B] with its
// lanes ld values apart, boxes [L, size, C]), and the arrays and their
// lane stride.
template <typename T, typename Fs>
struct FwdInputs {
  CUtensorMap map[Fs::NF];
  const T* ptr[Fs::NF];
  int ld;
};

// Fill `in` from the fields' addresses; returns the CUDA error of a tensor
// map (tma.cuh::encode_map_3d), else 0.
template <typename T, typename Fs>
int fwd_inputs(FwdInputs<T, Fs>& in, const void* const* fields, int N,
               int B, int ld, int L, int C) {
  in.ld = ld;
  for (int f = 0; f < Fs::NF; ++f) {
    in.ptr[f] = static_cast<const T*>(fields[f]);
    const int err = encode_map_3d<T>(&in.map[f], fields[f], B, Fs::size(f),
                                     N, ld, L, Fs::size(f), C);
    if (err != 0) return err;
  }
  return 0;
}

// Each field's region in a buffer of C stages of `stride` lanes.
template <typename T, typename Fs>
struct FwdLayout {
  int off[Fs::NF];
  int stride;
  __device__ FwdLayout(int C, int lanes) : stride(lanes) {
#pragma unroll
    for (int f = 0; f < Fs::NF; ++f) off[f] = fwd_region<T, Fs>(f, C, lanes);
  }
};

// A lane's view of an acquired chunk: value e of field f of the chunk's
// stage s.
template <typename T, typename Fs>
struct FwdView {
  const T* p;   // the lane's column of the chunk's buffer
  FwdLayout<T, Fs> l;
  __device__ T operator()(int f, int s, int e) const {
    return p[l.off[f] + (s * Fs::size(f) + e) * l.stride];
  }
};

// The producer warp: thread f < NF issues field f's box of every
// chunk; thread 0 first waits until every consumer warp left the buffer
// and arms its full barrier for the chunk's bytes (a box counts its full
// size past the array's bounds).
template <typename T, typename Fs, int R>
__device__ __forceinline__ void fwd_produce(const StageRing<T, R>& ring,
                                            const FwdInputs<T, Fs>& in,
                                            const FwdLayout<T, Fs>& l,
                                            int base, int N, int C) {
  const int f = static_cast<int>(threadIdx.x % 32);
  const int at_f = f < Fs::NF ? l.off[f] : 0;
  const uint32_t bytes =
      static_cast<uint32_t>(C * Fs::F * l.stride * sizeof(T));
  const int n = fwd_chunks(N, C);
  for (int c = 0; c < n; ++c) {
    const int s = c % R;
    if (f == 0) {
      if (c >= R)
        mbar_wait(&ring.empty[s], static_cast<uint32_t>((c / R - 1) & 1));
      mbar_arm(&ring.full[s], bytes);
    }
    __syncwarp();
    if (f < Fs::NF)
      tma_load_3d(in.map[f], &ring.full[s],
                  ring.buffers + s * ring.buffer + at_f, base, 0, c * C);
  }
}

// A block of a forward kernel: L lanes of G threads, then the producer
// warp.  Set up the ring and run `body(feed, layout, at)` on every
// consumer lane's group (a warp wholly past the batch returns at once).
// Every thread of the block calls it.
template <typename T, typename Fs, int G, int C, typename Body>
__device__ __forceinline__ void fwd_block(const FwdInputs<T, Fs>& in, int N,
                                          int B, const Body& body) {
  constexpr int R = fwd_ring<T>(Fs::F, C);
  constexpr int W = 32 / G;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = (static_cast<int>(blockDim.x) - 32) / G;
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const FwdLayout<T, Fs> l(C, L);
  const StageRing<T, R> ring(smem_raw, fwd_buffer_bytes<T, Fs>(C, L));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], (lanes + W - 1) / W);   // warps with lanes
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= L * G) {         // the producer warp
    fwd_produce<T, Fs, R>(ring, in, l, base, N, C);
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                  // a warp wholly past the batch
  StageRingFeed<T, R> feed{ring, at.b - base, L};
  body(feed, l, at);
}

// The stages of chunk c of a lane's horizon, `stage(view, s, i)` on stage
// s of the chunk (stage i of the horizon): a whole chunk unrolled, so that
// the compiler may read a later stage's fields early; the last, shorter
// chunk one stage at a time.
template <typename T, typename Fs, int C, typename Feed, typename Stage>
__device__ __forceinline__ void fwd_chunk_stages(Feed& feed,
                                                 const FwdLayout<T, Fs>& l,
                                                 int c, int N,
                                                 const Stage& stage) {
  const FwdView<T, Fs> v{feed.acquire(c), l};
  const FwdChunk k = fwd_chunk_at(c, N, C);
  if (k.hi - k.start == C) {
#pragma unroll
    for (int s = 0; s < C; ++s) stage(v, s, k.start + s);
  } else {
    for (int i = k.start; i < k.hi; ++i) stage(v, i - k.start, i);
  }
}

// The N stages of a lane's horizon with each stage's fields read into
// registers (`load(view, s)`) before the stage ahead of it runs
// (`run(fields, i)`), for a stage whose branches keep the compiler from
// reading early on its own (K6's generated step): chunk c + 1 is acquired
// at chunk c's last stage, once that stage's fields are in registers.
template <typename T, typename Fs, int C, typename Feed, typename Load,
          typename Run>
__device__ __forceinline__ void fwd_stages_ahead(Feed& feed,
                                                 const FwdLayout<T, Fs>& l,
                                                 int N, const Load& load,
                                                 const Run& run) {
  const int n = fwd_chunks(N, C);
  FwdView<T, Fs> v{feed.acquire(0), l};
  auto cur = load(v, 0);
  for (int c = 0; c < n; ++c) {
    const FwdChunk k = fwd_chunk_at(c, N, C);
    auto step = [&](int s) {
      decltype(cur) next;
      if (k.start + s + 1 < k.hi) {
        next = load(v, s + 1);
      } else if (c + 1 < n) {
        v = FwdView<T, Fs>{feed.acquire(c + 1), l};
        next = load(v, 0);
      }
      run(cur, k.start + s);
      cur = next;
    };
    if (k.hi - k.start == C) {
#pragma unroll
      for (int s = 0; s < C; ++s) step(s);
    } else {
      for (int s = 0; s < k.hi - k.start; ++s) step(s);
    }
  }
}

}  // namespace nmpc

// Chunked DDP Riccati backward for Hopper (sm_90a): stage fields staged in
// shared memory a chunk of C stages at a time.
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_chunked (kernel _make_kernel_chunked, chunk
// chooser _choose_chunk): K1's recursion (ddp_backward.cuh) with the
// seven derivative fields fetched C stages at a time.  Same inputs and
// outputs as K1.
//
// What bounds it on the card: as K1, the latency of each lane's chain of
// stages; with the stage split over a group of threads, bytes count
// again: ~5.9 KB per 32 lanes and stage at (4, 1) fp32 must arrive in
// time.
//
// What the design does about it: K1's lane groups and loop
// (ddp_backward.cuh::group_backward, riccati_stage_group on G = kRowGroup
// threads per lane, row_lanes(B) lanes a block), fed by cp.async, which
// holds no register per copy and takes any lane stride (a ragged B needs
// no copy), double-buffered by chunk as the TPU kernel is: chunk c+1 is
// in flight while chunk c's C stages compute.  Each warp's slab is
// [slot][C][F][W] (W = 32 / G lanes, the packed order within a stage,
// lanes fastest: the group's reads are broadcasts, the lanes' neighbouring
// words).  The G threads of a lane split each stage's F values (thread r
// copies the values e = r mod G, ~F / G a stage), so for each copy a warp
// reads G runs of W neighbouring lanes and writes 32 neighbouring words;
// the warp meets at __syncwarp after its copies of a chunk landed, before
// any thread reads values another copied, and again before a slot is
// refilled.  C comes from the shared-memory budget (row_group.cuh::
// chunked_chunk_stages, 2 C F sizeof(T) bytes a lane); when C does not
// divide N the last chunk (stages 0 .. N mod C - 1) is shorter, where the
// TPU kernel required C | N.  A lane past the batch's end copies nothing
// and reads the last lane's column.

#pragma once

#include "cp_async.cuh"
#include "ddp_backward.cuh"

namespace nmpc {

// The seven derivative fields, each a batch-minor [N, n, m, B] array.
template <typename T>
struct DerivFields {
  const T* __restrict__ Fx;
  const T* __restrict__ Fu;
  const T* __restrict__ Lx;
  const T* __restrict__ Lu;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
};

// Copy this thread's share of field `src` ([N, SIZE, B], at packed offset
// OFF) for stages lo .. hi - 1 of lane b: element j of stage i, whose
// packed index OFF + j is r mod G, to slab[((i - start) F + OFF + j) W].
template <typename T, int SIZE, int OFF, int F, int G>
__device__ __forceinline__ void copy_field(const T* __restrict__ src,
                                           int start, int lo, int hi, int b,
                                           int B, T* slab) {
  constexpr int W = 32 / G;
  const int j0 = (LaneGroup<G>::rank() - OFF) & (G - 1);
  for (int i = lo; i < hi; ++i) {
    const T* row = src + static_cast<size_t>(i) * SIZE * B + b;
    T* dst = slab + (static_cast<size_t>(i - start) * F + OFF) * W;
    for (int j = j0; j < SIZE; j += G) cp_async<T>(dst + j * W, row + j * B);
  }
}

// Each warp's two slots of C stages, filled by cp.async from the lanes'
// own threads, the G of a lane splitting its values.
template <typename T, int NX, int NU, int G>
struct CpAsyncFeed {
  static constexpr int F = PackedLayout<NX, NU>::F;
  static constexpr int stride = 32 / G;
  DerivFields<T> f;
  T* slots;       // the warp's two slots
  size_t slot;    // values between them
  int N, C, n, b, B, col;
  bool live;

  __device__ CpAsyncFeed(const DerivFields<T>& fields, T* warp_slots,
                         const GroupLane<G>& at, int N_, int C_, int B_)
      : f(fields),
        slots(warp_slots),
        slot(static_cast<size_t>(C_) * F * (32 / G)),
        N(N_), C(C_), n(packed_chunks(N_, C_)), b(at.b), B(B_),
        col(at.b - at.lane0), live(at.live) {
    issue(0);
  }

  // chunk c into slot c % 2, closed as one group of copies
  __device__ void issue(int c) {
    if (live) {
      using P = PackedLayout<NX, NU>;
      const PackedChunk k = packed_chunk(c, N, C);
      T* dst = slots + (c & 1) * slot + col;
      copy_field<T, NX * NX, P::Fx, F, G>(f.Fx, k.start, k.lo, k.hi, b, B, dst);
      copy_field<T, NX * NU, P::Fu, F, G>(f.Fu, k.start, k.lo, k.hi, b, B, dst);
      copy_field<T, NX, P::Lx, F, G>(f.Lx, k.start, k.lo, k.hi, b, B, dst);
      copy_field<T, NU, P::Lu, F, G>(f.Lu, k.start, k.lo, k.hi, b, B, dst);
      copy_field<T, NX * NX, P::Lxx, F, G>(f.Lxx, k.start, k.lo, k.hi, b, B,
                                           dst);
      copy_field<T, NU * NU, P::Luu, F, G>(f.Luu, k.start, k.lo, k.hi, b, B,
                                           dst);
      copy_field<T, NX * NU, P::Lxu, F, G>(f.Lxu, k.start, k.lo, k.hi, b, B,
                                           dst);
    }
    cp_async_commit();
  }

  __device__ const T* acquire(int c) {
    // the warp is done with chunk c - 1, whose slot chunk c + 1 takes
    if (c > 0) __syncwarp();
    if (c + 1 < n) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();   // every thread's copies of chunk c have landed
    return slots + (c & 1) * slot + col;
  }
};

template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kMaxRowLanes * G)
ddp_backward_chunked_kernel(DerivFields<T> f, const T* __restrict__ VxT,
                            const T* __restrict__ VxxT,
                            const T* __restrict__ lam_in, BackwardOut<T> out,
                            int N, int B, int C, int reg_type) {
  constexpr int F = PackedLayout<NX, NU>::F;
  constexpr int W = 32 / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupLane<G> at(B, static_cast<int>(blockDim.x) / G);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  CpAsyncFeed<T, NX, NU, G> feed(
      f, reinterpret_cast<T*>(smem_raw) + at.warp * 2 * C * F * W, at, N, C,
      B);
  group_backward<T, NX, NU, G, PackedLayout<NX, NU>>(
      feed, at, N, C, B, reg_type, VxT, VxxT, lam_in, out);
}

// Launch on `stream` with C = chunked_chunk_stages (row_group.cuh) stages
// per chunk and the warps' slots in dynamic shared memory (the opt-in
// above 48 KB is set here); returns the CUDA error of the attribute call
// or cudaGetLastError() after the launch.  Arguments as K1's launch, with
// contiguous fields (any B).
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward_chunked(int N, int B, int reg_type,
                                const void* const* fields, const void* VxT,
                                const void* VxxT, const void* lam, void* ks,
                                void* Ks, void* dV, void* ok, void* stream) {
  constexpr int F = PackedLayout<NX, NU>::F;
  constexpr int W = 32 / G;
  static_assert((kMaxRowLanes / W) * chunked_warp_bytes<T>(1, F, W) <=
                    kMaxBlockSmem,
                "a block's slots of one-stage chunks pass its shared memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const DerivFields<T> f{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  const int C = chunked_chunk_stages<T>(F, N);
  const int L = row_lanes<G>(B);
  const size_t smem = (L / W) * chunked_warp_bytes<T>(C, F, W);
  const int err = allow_dynamic_smem(ddp_backward_chunked_kernel<T, NX, NU, G>,
                                     smem);
  if (err != 0) return err;
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  ddp_backward_chunked_kernel<T, NX, NU, G>
      <<<(B + L - 1) / L, L * G, smem, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), out, N, B, C, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

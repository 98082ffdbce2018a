// Chunked DDP Riccati backward for Hopper (sm_90a): stage fields staged in
// shared memory a chunk of C stages at a time.
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_chunked (kernel _make_kernel_chunked, chunk
// chooser _choose_chunk): K1's recursion (ddp_backward.cuh) with the
// seven derivative fields fetched C stages at a time.  Same inputs and
// outputs as K1; the stage is riccati_stage.cuh::riccati_stage, unchanged,
// so the result equals K1's bit for bit.
//
// What bounds it on the card: as K1 (ddp_backward.cuh), the latency of
// each lane's chain of stages on one thread; of the loads (46 values per
// stage and lane at (nx, nu) = (4, 1)), K1 keeps only the next stage's in
// flight per thread.
//
// What the design does about it: a block of L = 32 lanes (one thread per
// lane) keeps a whole chunk of C stages in flight with cp.async, which
// holds no register per copy, double-buffered at chunk granularity:
// chunk c+1 is in flight while chunk c's C stages compute.  Shared memory
// is laid out [slot][stage][field element][lane] (the packed order of
// ddp_backward_packed.cuh within a stage), so a warp's copies of one field
// element are 32 neighbouring lanes (one coalesced request) and its reads
// hit 32 neighbouring words (no bank conflict).  Each thread copies and
// reads only its own lane's column, so the chunk needs no block barrier.
// C comes from the shared-memory budget (the wrapper's chunk_stages:
// 2 * C * F * L scalars); when C does not divide N the last chunk (stages
// 0 .. N mod C - 1) is shorter, where the TPU kernel required C | N.
// Chunks run from the end of the horizon: chunk c holds stages
// [max(0, N - (c+1) C), N - c C).

#pragma once

#include "cp_async.cuh"
#include "ddp_backward.cuh"

namespace nmpc {

// Copy field `src` ([N, SIZE, B]) of stages base .. base+len-1 of lane b
// into the slab: element j of stage base+pos at slab[(pos F + off + j) L].
template <typename T, int SIZE>
__device__ __forceinline__ void stage_field(const T* __restrict__ src,
                                            int off, int F, int base, int len,
                                            int b, int B, T* slab, int L) {
  for (int pos = 0; pos < len; ++pos) {
    const T* row = src + static_cast<size_t>(base + pos) * SIZE * B + b;
    T* dst = slab + (static_cast<size_t>(pos) * F + off) * L;
#pragma unroll
    for (int j = 0; j < SIZE; ++j) cp_async<T>(dst + j * L, row + j * B);
  }
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void stage_chunk(const DerivFields<T>& f, int base,
                                            int len, int b, int B, T* slab,
                                            int L) {
  using P = PackedLayout<NX, NU>;
  stage_field<T, NX * NX>(f.Fx, P::Fx, P::F, base, len, b, B, slab, L);
  stage_field<T, NX * NU>(f.Fu, P::Fu, P::F, base, len, b, B, slab, L);
  stage_field<T, NX>(f.Lx, P::Lx, P::F, base, len, b, B, slab, L);
  stage_field<T, NU>(f.Lu, P::Lu, P::F, base, len, b, B, slab, L);
  stage_field<T, NX * NX>(f.Lxx, P::Lxx, P::F, base, len, b, B, slab, L);
  stage_field<T, NU * NU>(f.Luu, P::Luu, P::F, base, len, b, B, slab, L);
  stage_field<T, NX * NU>(f.Lxu, P::Lxu, P::F, base, len, b, B, slab, L);
  cp_async_commit();
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
ddp_backward_chunked_kernel(DerivFields<T> f, const T* __restrict__ VxT,
                            const T* __restrict__ VxxT,
                            const T* __restrict__ lam_in, T* __restrict__ ks,
                            T* __restrict__ Ks, T* __restrict__ dV,
                            unsigned char* __restrict__ ok_out, int N, int B,
                            int C, int reg_type) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int F = PackedLayout<NX, NU>::F;
  const int L = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * L + t;
  // no block barrier below: a lane past B has nothing to copy or compute
  if (b >= B) return;
  T* smem = reinterpret_cast<T*>(smem_raw) + t;       // this lane's column
  const size_t slot = static_cast<size_t>(C) * F * L;

  const int n_chunks = (N + C - 1) / C;
  auto chunk_base = [N, C](int c) { return max(0, N - (c + 1) * C); };
  stage_chunk<T, NX, NU>(f, chunk_base(0), N - chunk_base(0), b, B, smem, L);

  Carry<T, NX> carry;
  init_carry<T, NX>(VxT, VxxT, b, B, carry);
  const T lam = lam_in[b];

  for (int c = 0; c < n_chunks; ++c) {
    const int hi = N - c * C;
    const int base = chunk_base(c);
    if (c + 1 < n_chunks) {
      // the other slot held chunk c-1, consumed in the previous trip
      const int nb = chunk_base(c + 1);
      stage_chunk<T, NX, NU>(f, nb, base - nb, b, B,
                             smem + ((c + 1) & 1) * slot, L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const T* slab = smem + (c & 1) * slot;
    for (int i = hi - 1; i >= base; --i) {
      Stage<T, NX, NU> cur;
      load_stage_packed<T, NX, NU>(
          slab + static_cast<size_t>(i - base) * F * L, L, cur);
      T k[NU], K[NU][NX];
      riccati_stage<T, NX, NU>(cur, lam, reg_type, carry, k, K);
      store_gains<T, NX, NU>(k, K, i, b, B, ks, Ks);
    }
  }
  store_result<T, NX>(carry, b, B, dV, ok_out);
}

// Launch on `stream` with C stages per chunk and 2 * C * F * 32 scalars of
// dynamic shared memory (the opt-in above 48 KB is set here); returns the
// CUDA error of the attribute call or cudaGetLastError() after the launch.
// Arguments as K1's launch.
template <typename T, int NX, int NU>
int launch_ddp_backward_chunked(int N, int B, int C, int reg_type,
                                const void* const* fields, const void* VxT,
                                const void* VxxT, const void* lam, void* ks,
                                void* Ks, void* dV, void* ok, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const DerivFields<T> f{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  const size_t smem = 2 * static_cast<size_t>(C) *
                      PackedLayout<NX, NU>::F * kLaneThreads * sizeof(T);
  const int err = allow_dynamic_smem(ddp_backward_chunked_kernel<T, NX, NU>,
                                     smem);
  if (err != 0) return err;
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  ddp_backward_chunked_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), static_cast<T*>(ks),
          static_cast<T*>(Ks), static_cast<T*>(dV),
          static_cast<unsigned char*>(ok), N, B, C, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

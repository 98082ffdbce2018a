// K2 at the wide shapes: the chunked DDP Riccati backward for Hopper
// (sm_90a) where (NX, NU) passes the narrow kernels' sizes (row_group.cuh::
// kWideStage: nx > 8 or nu > 4; the centroidal model's (9, 16)).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_chunked (:651, kernel _make_kernel_chunked :511,
// chunk chooser _choose_chunk :615) at those shapes, as
// ddp_backward_chunked.cuh does at the others: K1's recursion with the
// seven derivative fields fetched C stages at a time.  Same inputs and
// outputs as K1; its plain twin is nmpc_tpu_torch/kernels/
// ddp_backward.py::backward_stacked.  The wrapper (kernels/
// ddp_backward_fused.py) builds this header's launch for a wide shape.
//
// What bounds it on the card: as K1-wide (ddp_backward_wide.cuh), each
// lane's chain of N dependent stages, ~10 us a stage at (9, 16) whatever
// the batch; the fields (731 values a lane and stage, 91 MB at B=256,
// N=100, fp32) need only arrive a chunk ahead.
//
// What the design does about it: K1-wide's stage (riccati_stage_wide.cuh
// on G = kRowGroup threads a lane: 32, a lane a warp), its lanes a block
// and each lane's scratch (WideChunkBlock, ddp_backward_wide.cuh), fed by
// ddp_backward_chunked.cuh's cp.async slots: each warp's two slots of C
// stages ([C][F][W], W = 32 / G lanes of the warp, the packed order,
// lanes fastest; at G = 32 a lane's [C][F] values, one after another),
// filled by the warp's own threads, the G of a lane splitting its values
// (thread r copies the values e = r mod G), double-buffered by chunk:
// chunk c + 1 is in flight while chunk c's stages compute.  The warp
// meets at __syncwarp after its copies of a chunk landed and before a
// slot is refilled; no warp reads another's slots, so no block barrier.
// At G = 32 each copy is a 4- or 8-byte read of its own row of a field:
// slow, but a chunk has C stages' compute to arrive in.  C comes from the
// shared-memory budget (row_group.cuh::wide_chunk_stages: 9 at (9, 16)
// fp32, 4 at fp64); when C does not divide N the last chunk is shorter,
// where the TPU kernel required C | N.  The stage and the order of every
// sum are K1-wide's, built with -fmad=false, so the result equals
// K1-wide's bit for bit.  A lane past the batch's end reads the last
// lane's column and stores nothing; a warp wholly past it returns at
// once.

#pragma once

#include "ddp_backward_chunked.cuh"
#include "ddp_backward_wide.cuh"

namespace nmpc {

template <typename T, int NX, int NU, int G>
using WideChunkedBlock = WideChunkBlock<T, NX, NU, G, 1>;

// A block: L lanes of G threads, no producer; the warps' slots after the
// block's first 128 bytes, the lanes' scratch after the two buffers.
template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(WideChunkedBlock<T, NX, NU, G>::lanes * G)
ddp_backward_chunked_wide_kernel(DerivFields<T> f, const T* __restrict__ VxT,
                                 const T* __restrict__ VxxT,
                                 const T* __restrict__ lam_in,
                                 BackwardOut<T> out, int N, int B, int C,
                                 int reg_type) {
  using Block = WideChunkedBlock<T, NX, NU, G>;
  constexpr int W = 32 / G;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = static_cast<int>(blockDim.x) / G;
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  CpAsyncFeed<T, NX, NU, G> feed(
      f,
      reinterpret_cast<T*>(smem_raw + 128) +
          static_cast<size_t>(at.warp) * 2 * C * Block::F * W,
      at, N, C, B);
  T* scratch = reinterpret_cast<T*>(
      smem_raw + ring_bytes<T>(2, 1, C * Block::F, L));
  wide_backward<T, NX, NU, G, W, PackedLayout<NX, NU>>(
      feed, at, N, C, B, reg_type, VxT, VxxT, lam_in, out,
      scratch + static_cast<size_t>(threadIdx.x / G) * Block::One::stride);
}

// Launch on `stream` with C = min(WideChunkedBlock::chunk, N) stages a
// chunk and WideBlock::lanes(B) lanes a block, the slots and scratch in
// dynamic shared memory (the opt-in above 48 KB set here); arguments and
// result as ddp_backward_chunked.cuh::launch_ddp_backward_chunked.
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward_chunked_wide(int N, int B, int reg_type,
                                     const void* const* fields,
                                     const void* VxT, const void* VxxT,
                                     const void* lam, void* ks, void* Ks,
                                     void* dV, void* ok, void* stream) {
  using Block = WideChunkedBlock<T, NX, NU, G>;
  static_assert(Block::lanes * G <= 1024, "a wide block passes 1024 threads");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const DerivFields<T> f{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  const int C = Block::chunk < N ? Block::chunk : N;
  const int L = Block::One::lanes(B);
  const size_t smem = Block::bytes(C, L);
  const int err = allow_dynamic_smem(
      ddp_backward_chunked_wide_kernel<T, NX, NU, G>, smem);
  if (err != 0) return err;
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  ddp_backward_chunked_wide_kernel<T, NX, NU, G>
      <<<(B + L - 1) / L, L * G, smem, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), out, N, B, C, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

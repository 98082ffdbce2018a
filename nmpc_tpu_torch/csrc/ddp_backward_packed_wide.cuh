// K3 at the wide shapes: the packed-input DDP Riccati backward for Hopper
// (sm_90a) where (NX, NU) passes the narrow kernels' sizes (row_group.cuh::
// kWideStage: nx > 8 or nu > 4; the centroidal model's (9, 16)).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_packed (:1113, kernel _make_kernel_packed :701,
// buffer pack_derivs_pallas :1164) at those shapes, as
// ddp_backward_packed.cuh does at the others: K1's recursion with every
// stage's seven fields read from one packed [N, F, B] buffer
// (kernels/ddp_backward_fused.py::pack_derivs; F = 731 at (9, 16)).  Its
// plain version unpacks the buffer and runs backward_stacked.
//
// What bounds it on the card: as K1-wide (ddp_backward_wide.cuh), each
// lane's chain of N dependent stages, ~10 us a stage at (9, 16); the
// buffer need only arrive a chunk ahead.
//
// What the design does about it: K1-wide's block (WideChunkBlock: its
// lanes, the stage riccati_stage_wide.cuh on G = kRowGroup threads a
// lane, each lane's scratch) and its producer warp, whose first thread
// keeps a ring of two buffers of C stages of the block's L lanes full by
// TMA (K1's StageRing: a full and an empty mbarrier a buffer), from the
// end of the horizon.  A narrow K3's box (a warp's lanes x F values x C
// stages) does not carry over: a box row must be 16 bytes (4 lanes at
// fp32) and a lane here is a warp, and every extent is at most 256 where
// a stage holds 731 values.  So the map sees the buffer as N F rows of B
// lanes (row i F + e is value e of stage i: the rows of [N, F, B] are one
// stride apart) and a chunk of C stages, C F consecutive rows, arrives
// in boxes of kWideBoxRows rows x L lanes, one after another in the
// buffer ([rows][L], lanes fastest: stage i of the chunk at (i - start) F
// L values, the packed order, no padding between stages), each landing
// 128-byte aligned (256 rows of at least 16 bytes); the buffer holds C F
// rows rounded up to whole boxes, and the rows past the chunk's (the
// next stages', or zeros past the buffer's end) are never read.  Each
// box row starts at the block's first lane, a multiple of 4 lanes (16
// bytes at fp32).  A box wholly before row 0 (the last chunk's, when C
// does not divide N) is not issued, and one partly before it arrives
// zero-filled there.  C and the ring come from the shared-memory budget
// (row_group.cuh::wide_chunk_stages: 8 at (9, 16) fp32, 3 at fp64).  The
// stage and the order of every sum are K1-wide's, built with
// -fmad=false, so the result equals K1-wide's bit for bit.  TMA takes a
// lane stride of a multiple of 16 bytes: the wrapper copies any other
// buffer into one padded to such a stride (padded_packed).  A lane past
// the batch's end runs the last lane's column and stores nothing, and a
// warp wholly past it returns at once.

#pragma once

#include "ddp_backward_wide.cuh"

namespace nmpc {

template <typename T, int NX, int NU, int G>
using WidePackedBlock = WideChunkBlock<T, NX, NU, G, kWideBoxRows>;

// A block: L lanes of G threads (the consumer warps), then one producer
// warp filling the ring from the packed buffer's map; the lanes' scratch
// after the ring.  One kernel for each L a launch takes
// (WideBlock::lanes), so that the slab's lane stride is a constant.
template <typename T, int NX, int NU, int G, int L>
__global__ void __launch_bounds__(L * G + 32)
ddp_backward_packed_wide_kernel(const __grid_constant__ CUtensorMap map,
                                const T* __restrict__ VxT,
                                const T* __restrict__ VxxT,
                                const T* __restrict__ lam_in,
                                BackwardOut<T> out, int N, int B, int C,
                                int reg_type) {
  using Block = WidePackedBlock<T, NX, NU, G>;
  constexpr int F = Block::F;
  constexpr int W = 32 / G;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const int rows = wide_chunk_rows(C, F, kWideBoxRows);
  const StageRing<T, 2> ring(smem_raw, packed_buffer_bytes<T>(1, rows, L));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], (lanes + W - 1) / W);   // warps with lanes
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= L * G) {       // the producer warp
    if (threadIdx.x % 32 != 0) return;
    auto load = [&map, base, N, C, rows](int c, T* dst, uint64_t* bar) {
      const int first = packed_chunk(c, N, C).start * F;   // may be < 0
      const int skip = first < 0 ? -first / kWideBoxRows : 0;
      const int boxes = rows / kWideBoxRows;
      mbar_arm(bar, static_cast<uint32_t>((boxes - skip) * kWideBoxRows * L *
                                          sizeof(T)));
      for (int j = skip; j < boxes; ++j)
        tma_load_3d(map, bar, dst + static_cast<size_t>(j) * kWideBoxRows * L,
                    base, first + j * kWideBoxRows, 0);
    };
    ring.produce(packed_chunks(N, C), load);
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  T* scratch = reinterpret_cast<T*>(smem_raw + ring_bytes<T>(2, 1, rows, L));
  StageRingFeed<T, 2> feed{ring, at.b - base, L};
  wide_backward<T, NX, NU, G, L, PackedLayout<NX, NU>>(
      feed, at, N, C, B, reg_type, VxT, VxxT, lam_in, out,
      scratch + static_cast<size_t>(threadIdx.x / G) * Block::One::stride);
}

// Launch on `stream` with C = min(WidePackedBlock::chunk, N) stages a
// chunk and WideBlock::lanes(B) lanes a block; arguments and result as
// ddp_backward_packed.cuh::launch_ddp_backward_packed (fields[0]: the
// packed [N, F, B] buffer, its lanes ld values apart, ld * sizeof(T) and
// its address multiples of 16 bytes).
template <typename T, int NX, int NU, int G = kRowGroup<NX, NU>>
int launch_ddp_backward_packed_wide(int N, int B, int ld, int reg_type,
                                    const void* const* fields,
                                    const void* VxT, const void* VxxT,
                                    const void* lam, void* ks, void* Ks,
                                    void* dV, void* ok, void* stream) {
  using Block = WidePackedBlock<T, NX, NU, G>;
  constexpr int most = Block::lanes;
  static_assert(most * G + 32 <= 1024, "a wide block passes 1024 threads");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int C = Block::chunk < N ? Block::chunk : N;
  const int L = Block::One::lanes(B);
  CUtensorMap map;
  const int err = encode_map_3d<T>(&map, fields[0], B, N * Block::F, 1, ld,
                                   L, kWideBoxRows, 1);
  if (err != 0) return err;
  const BackwardOut<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                           static_cast<T*>(dV),
                           static_cast<unsigned char*>(ok)};
  return with_lanes<wide_min_lanes<G>(), most>(L, [&](auto lanes) {
    constexpr int LL = decltype(lanes)::value;
    const size_t smem = Block::bytes(C, LL);
    const int e = allow_dynamic_smem(
        ddp_backward_packed_wide_kernel<T, NX, NU, G, LL>, smem);
    if (e != 0) return e;
    ddp_backward_packed_wide_kernel<T, NX, NU, G, LL>
        <<<(B + LL - 1) / LL, LL * G + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
            map, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
            static_cast<const T*>(lam), out, N, B, C, reg_type);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace nmpc

// Packed FMPC condensed Riccati backward for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call_packed (kernel _make_kernel_packed): K8's
// recursion (fmpc_backward.cuh) with every stage's 12 input fields read
// from one [N, Fin, B] buffer and the four outputs written to one
// [N, Fout, B] buffer, in the order and at the offsets of _field_offsets
// (fmpc_group.cuh::FmpcPackedLayout): inputs A, B, C, D, Lxx, Luu, Lxu,
// x_bar, Lx_bar, Lu_bar, nu_s, tilde; outputs k, K, s, P; every matrix
// row-major (Fin = 78, Fout = 25 at the cart-pole's (nx, nu, ng) = (4, 1,
// 4)).  The wrapper (kernels/fmpc_backward.py) condenses and packs with
// torch ops and slices the outputs back; the plain version unpacks, runs
// the torch recursion and packs.
//
// What bounds it on the card: as K8, the per-lane dependent chain (~600
// flops per stage between a stage's 78 reads and 25 writes); and the pack
// and unpack around it read and write every field once more.
//
// What the design does about it: K8's loop (fmpc_backward.cuh::
// fmpc_group_backward: a group of kFmpcPackedGroup threads per lane
// running fmpc_stage_group, row_lanes(B) lanes a block), so the result equals
// K8's bit for bit (both built with -fmad=false), fed as K3 feeds K1's
// loop (ddp_backward_packed.cuh::TmaRingFeed): each warp's first thread
// loads chunks of C stages x Fin values x W lanes (W = 32 / G; [C][Fin][W]
// in shared memory, lane fastest) into the warp's ring of kPackedRing
// buffers by TMA, each with its own mbarrier, from the end of the
// horizon; the stage's scalings nu_s and tilde are read from the chunk.
// A box takes at most 256 values a stage: a larger Fin comes one stage a
// chunk in boxes of 256 (fmpc_group.cuh).  TMA takes a lane stride (ld
// values) of a multiple of 16 bytes: the wrapper copies a buffer whose B
// is not into one padded to such an ld.  The terminal (s_T, P_T) is not
// written (the wrapper appends it) but enters the finite flag, as in K8.

#pragma once

#include "ddp_backward_packed.cuh"
#include "fmpc_backward.cuh"

namespace nmpc {

template <typename T, int NX, int NU, int NG, int G, bool SHARE>
__global__ void __launch_bounds__(kMaxRowLanes * G)
fmpc_backward_packed_kernel(const __grid_constant__ CUtensorMap map,
                            FmpcRun<T> run, FmpcSink<T> out, int N, int B,
                            int C) {
  using O = FmpcPackedLayout<NX, NU, NG>;
  constexpr int W = 32 / G;                 // lanes of a warp
  constexpr int box = fmpc_box_values(O::F);
  constexpr int pieces = fmpc_box_pieces(O::F);
  constexpr int slot = fmpc_slot_values(O::F);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const GroupLane<G> at(B, static_cast<int>(blockDim.x) / G);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  const int lane0 = at.lane0;
  const uint32_t bytes = static_cast<uint32_t>(C) * slot * W * sizeof(T);
  auto load = [&map, lane0, N, C, bytes](int c, T* dst, uint64_t* bar) {
    mbar_arm(bar, bytes);
    const int start = packed_chunk(c, N, C).start;
#pragma unroll
    for (int q = 0; q < pieces; ++q)
      tma_load_3d(map, bar, dst + q * box * W, lane0, q * box, start);
  };
  TmaRingFeed<T, kPackedRing, W, decltype(load)> feed(
      smem_raw + at.warp * ring_bytes<T>(kPackedRing, C, slot, W),
      packed_buffer_bytes<T>(C, slot, W), packed_chunks(N, C), at.b - lane0,
      at.leader(), load);
  auto stage_of = [](const T* slab, int s, int) {
    return PackedStageFields<T, NX, NU, NG>{
        slab + static_cast<size_t>(s) * O::F * W, W};
  };
  fmpc_group_backward<T, NX, NU, NG, G, SHARE>(feed, stage_of, at, N, C, B,
                                               run, out);
}

// Launch on `stream`; returns a CUDA error code: of the tensor map
// (tma.cuh::encode_map_3d), of the shared-memory attribute, or
// cudaGetLastError() after the launch.  Pin [N, Fin, B] with its lanes ld
// values apart (ld * sizeof(T) and its address multiples of 16 bytes),
// out [N, Fout, B], sT [NX, B], PT [NX, NX, B] contiguous; ok and finite
// one byte per lane.  The chunk is fmpc_packed_chunk_stages' C; G and
// SHARE fmpc_group.cuh's rules unless a measurement asks for others.
template <typename T, int NX, int NU, int NG,
          int G = kFmpcPackedGroup<NX, NU>, bool SHARE = kFmpcShare<NX>>
int launch_fmpc_backward_packed(int N, int B, int ld, double dt,
                                int break_if_llt_fails, int check_nan,
                                const void* Pin, const void* sT,
                                const void* PT, void* out, void* ok,
                                void* finite, void* stream) {
  using O = FmpcPackedLayout<NX, NU, NG>;
  constexpr int W = 32 / G;
  static_assert(ring_bytes<T>(kPackedRing, 1, fmpc_slot_values(O::F), W) <=
                    kMaxBlockSmem,
                "a warp's ring of one-stage chunks passes a block's shared "
                "memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int C = fmpc_packed_chunk_stages<T>(O::F, N);
  const int L = fmpc_packed_lanes<T, G>(O::F, C, B);
  CUtensorMap map;
  int err = encode_map_3d<T>(&map, Pin, B, O::F, N, ld, W,
                             fmpc_box_values(O::F), C);
  if (err != 0) return err;
  const size_t smem = static_cast<size_t>(L / W) *
                      ring_bytes<T>(kPackedRing, C, fmpc_slot_values(O::F), W);
  err = allow_dynamic_smem(fmpc_backward_packed_kernel<T, NX, NU, NG, G, SHARE>,
                           smem);
  if (err != 0) return err;
  const size_t b = static_cast<size_t>(B);
  T* o = static_cast<T*>(out);
  const FmpcRun<T> run{static_cast<const T*>(sT),
                       static_cast<const T*>(PT),
                       false,
                       static_cast<T>(dt),
                       break_if_llt_fails != 0,
                       check_nan != 0,
                       static_cast<unsigned char*>(ok),
                       static_cast<unsigned char*>(finite)};
  const size_t stage = O::Fout * b;
  const FmpcSink<T> sink{o + O::k * b, o + O::K * b, o + O::s * b,
                         o + O::P * b, stage, stage, stage, stage, false};
  fmpc_backward_packed_kernel<T, NX, NU, NG, G, SHARE>
      <<<(B + L - 1) / L, L * G, smem, static_cast<cudaStream_t>(stream)>>>(
          map, run, sink, N, B, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

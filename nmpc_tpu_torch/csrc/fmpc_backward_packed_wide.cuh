// K10 at the wide shapes: the packed FMPC condensed Riccati backward for
// Hopper (sm_90a) where (NX, NU, NG) passes the narrow kernels' sizes
// (fmpc_group.cuh::kFmpcWide), up to (16, 16, 64).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call_packed (:632, kernel _make_kernel_packed) at
// those shapes, as fmpc_backward_packed.cuh does at the others: K8's
// recursion with every stage's 12 input fields (the condensation's nu/s
// and tilde among them) read from one [N, Fin, B] buffer
// (kernels/fmpc_backward.py::pack_fmpc_inputs; Fin = 906 at the masses'
// (12, 3, 30), 3,504 at (16, 16, 64)) and the outputs written to one [N,
// Fout, B] buffer.  Its plain version unpacks the buffer and runs
// solvers/fmpc.py::_riccati_condensed.
//
// What bounds it on the card: as K8-wide (fmpc_backward_wide.cuh), each
// lane's chain of N dependent stages; the buffer need only arrive a chunk
// ahead.
//
// What the design does about it: K8-wide's lanes, stage and recursion
// (fmpc_wide_backward, fmpc_stage_wide.cuh), fed as K3-wide is fed
// (ddp_backward_packed_wide.cuh).  A narrow K10's box (a warp's lanes x
// Fin values x C stages) does not carry over: a box row must be 16 bytes
// and every extent at most 256, where a stage holds 906 values.  So the
// map sees the buffer as N Fin rows of B lanes (row i Fin + e is value e
// of stage i), and a chunk of C stages, C Fin consecutive rows, arrives in
// boxes of kWideBoxRows rows x L lanes, one after another in the buffer
// (stage i of the chunk at (i - start) Fin L values, the packed order),
// each row starting at the block's first lane (16 bytes: 4 lanes at
// fp32, 2 at fp64) and each box landing 128-byte aligned; a box wholly
// before row 0 is not issued, one partly before it arrives zero-filled
// there.  The producer warp's first thread keeps a ring of two such
// buffers full (K1's StageRing), C from the shared-memory budget
// (fmpc_group.cuh::WideFmpcPackedBlock: 7 at the masses fp32, 3 at fp64).
// The stage and the order of every sum are K8-wide's, built with
// -fmad=false, so the result equals K8-wide's bit for bit.  TMA takes a
// lane stride of a multiple of 16 bytes: the wrapper copies any other
// buffer into one padded to such a stride.  The terminal (s_T, P_T) is
// not written (the wrapper appends it) but enters the finite flag.

#pragma once

#include "fmpc_backward_wide.cuh"

namespace nmpc {

// K10-wide's stage: stage s of a chunk of the packed buffer of the
// block's L lanes (value e of a field at p[(offset + e) L], offsets of
// FmpcPackedLayout), its scalings read as the buffer holds them.
template <typename T, int NX, int NU, int NG, int L>
struct WidePackedStage {
  using O = FmpcPackedLayout<NX, NU, NG>;
  const T* __restrict__ p;
  __device__ T at(int off, int e) const { return p[(off + e) * L]; }
  __device__ T A(int e) const { return at(O::A, e); }
  __device__ T Bm(int e) const { return at(O::Bm, e); }
  __device__ T C(int e) const { return at(O::C, e); }
  __device__ T D(int e) const { return at(O::D, e); }
  __device__ T Lxx(int e) const { return at(O::Lxx, e); }
  __device__ T Luu(int e) const { return at(O::Luu, e); }
  __device__ T Lxu(int e) const { return at(O::Lxu, e); }
  __device__ T xb(int e) const { return at(O::xb, e); }
  __device__ T Lxb(int e) const { return at(O::Lxb, e); }
  __device__ T Lub(int e) const { return at(O::Lub, e); }
  __device__ void scalings(int g, T& nu_s, T& tilde) const {
    nu_s = at(O::nu_s, g);
    tilde = at(O::tilde, g);
  }
};

// A block: L lanes of G threads (the consumer warps), then one producer
// warp filling the ring of two chunk buffers from the packed buffer's
// map; the lanes' scratch after the ring.
template <typename T, int NX, int NU, int NG, int G, int L>
__global__ void __launch_bounds__(L * G + 32)
fmpc_backward_packed_wide_kernel(const __grid_constant__ CUtensorMap map,
                                 FmpcRun<T> run, FmpcSink<T> out, int N,
                                 int B, int C) {
  using Block = WideFmpcPackedBlock<T, NX, NU, NG, G>;
  constexpr int Fin = Block::Fin;
  constexpr int W = 32 / G;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const int rows = wide_chunk_rows(C, Fin, kWideBoxRows);
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
      const int first = packed_chunk(c, N, C).start * Fin;   // may be < 0
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
  T* scratch = reinterpret_cast<T*>(smem_raw + ring_bytes<T>(2, 1, rows, L)) +
               static_cast<size_t>(threadIdx.x / G) * Block::stride;
  StageRingFeed<T, 2> feed{ring, at.b - base, L};
  auto stage_of = [](const T* slab, int s, int) {
    return WidePackedStage<T, NX, NU, NG, L>{
        slab + static_cast<size_t>(s) * Fin * L};
  };
  fmpc_wide_backward<T, NX, NU, NG, G>(feed, stage_of, at, N, C, B, run, out,
                                       scratch);
}

// Launch on `stream` with C = min(WideFmpcPackedBlock::chunk, N) stages
// a chunk and its lanes(B) lanes a block; the arguments and the result as
// fmpc_backward_packed.cuh::launch_fmpc_backward_packed's (Pin [N, Fin,
// B] with its lanes ld values apart, ld * sizeof(T) and its address
// multiples of 16 bytes).
template <typename T, int NX, int NU, int NG, int G = kFmpcWideGroup>
int launch_fmpc_backward_packed_wide(int N, int B, int ld, double dt,
                                     int break_if_llt_fails, int check_nan,
                                     const void* Pin, const void* sT,
                                     const void* PT, void* out, void* ok,
                                     void* finite, void* stream) {
  using Block = WideFmpcPackedBlock<T, NX, NU, NG, G>;
  using O = FmpcPackedLayout<NX, NU, NG>;
  constexpr FmpcWideRule<T> rule = Block::rule();
  constexpr int most = Block::max_lanes;
  static_assert(G != kFmpcWideGroup || rule.packed_fits(),
                "a wide block's two buffers of a stage and its scratch pass "
                "its shared memory");
  static_assert(most * G + 32 <= 1024, "a wide block passes 1024 threads");
  if (B <= 0 || N <= 0 || !rule.packed_fits())
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = Block::chunk < N ? Block::chunk : N;
  const int L = rule.packed_lanes(B);
  CUtensorMap map;
  const int err = encode_map_3d<T>(&map, Pin, B, N * Block::Fin, 1, ld, L,
                                   kWideBoxRows, 1);
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
  return with_lanes<Block::least, most>(L, [&](auto lanes_c) {
    constexpr int LL = decltype(lanes_c)::value;
    const size_t smem = rule.packed_bytes(C, LL);
    const int e = allow_dynamic_smem(
        fmpc_backward_packed_wide_kernel<T, NX, NU, NG, G, LL>, smem);
    if (e != 0) return e;
    fmpc_backward_packed_wide_kernel<T, NX, NU, NG, G, LL>
        <<<(B + LL - 1) / LL, LL * G + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(map, run, sink, N, B, C);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace nmpc

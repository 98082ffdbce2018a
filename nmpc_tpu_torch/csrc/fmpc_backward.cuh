// FMPC condensed primal-dual Riccati backward for Hopper (sm_90a), the
// kernel it shares with the resident backward and the lane-group loop it
// shares with the packed one.
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call (kernel _make_kernel, stage _fmpc_stage,
// inverse _inv_t; entry backward_fmpc_pallas).  Its plain version is
// nmpc_tpu_torch/solvers/fmpc.py::_backward_bm; the stage is
// fmpc_stage.cuh::fmpc_stage_group.
//
// The kernel takes s, nu and g_bar [N, NG, B], the inequality mask [N, NG]
// and eps [B] and forms the condensation scalings nu/s and tilde itself
// (fmpc_stage.cuh::fmpc_condense, in the order of the plain version's
// kernels/fmpc_backward.py::condensation), where the JAX wrapper leaves
// them to XLA to fuse (fmpc_backward_pallas.py:698-703): the wrapper
// launches no other op.  It writes the terminal (s_T, P_T) as row N of
// svecs and Ps, and the per-lane finite flag over every value it writes
// (the plain version's check_nan test).
//
// What bounds it on the card: the per-lane dependent chain, not bytes.
// Per stage and lane it reads 13 fields (82 values at the cart-pole's
// (nx, nu, ng) = (4, 1, 4)) and writes k, K, s and P (25 values), 176 MB
// at B = 4096, N = 100: 53 us at 3.35 TB/s; between them ~600 dependent
// flops (the condensation, three products with P, a Cholesky of G) with
// an IEEE division or square root every few dozen of them.  One thread
// per lane runs that chain from one warp per SM at B = 4096 and leaves
// 100 of 132 SMs idle at B = 1024.
//
// What the design does about it:
//   * a lane is a group of G = kFmpcGroup threads running
//     fmpc_stage_group (each owns rows of the NX-sized products, and rows
//     of NG in the condensation, fmpc_condense_group; every value is
//     computed by one thread in the one-thread order, so every G gives
//     the same bits, built with -fmad=false), and a block holds
//     fmpc_stream_lanes(B) lanes (fmpc_group.cuh): B = 4096 fills 128
//     blocks of four consumer warps, B = 1024 128 blocks of one;
//   * one producer warp per block keeps a ring of two buffers of C stages
//     of the block's L lanes full through the Tensor Memory Accelerator,
//     from the end of the horizon, in K1's ring (ddp_backward.cuh::
//     StageRing: a full and an empty mbarrier per buffer): a buffer is
//     filled by 13 boxes, one per field (a tensor map per field), each
//     bringing the field's C stages to the field's 128-byte aligned region
//     (FmpcStreamLayout, ChunkStageFields), thread f of the warp issuing
//     field f's box; chunks of C stages (fmpc_group.cuh::
//     fmpc_stream_chunk: 4 at the cart-pole fp32) cut the requests a stage
//     C-fold (a box a stage and field, issued by one thread, kept the
//     consumers waiting on TMA at the oscillator's short stage: PERF.md,
//     Findings); the consumers issue no copy.  The producer forms no
//     scaling: beside four consumer warps on an SM's four schedulers its
//     divisions slowed the cart-pole more than they cost in the consumers
//     (PERF.md, Findings);
//   * TMA takes a field at a 16-byte aligned address with its lanes a
//     multiple of 16 bytes apart: the wrapper copies any other field (B =
//     1023 at fp32, a view at an offset) once into a padded buffer; a
//     group past the batch's end reads the last lane's column and stores
//     nothing, a warp wholly past it returns at once;
//   * the Gauss-Jordan fallback runs only on lanes whose LLT failed.
// The kernel at CH = 0 is K9 (fmpc_backward_resident.cuh: one buffer of
// the whole horizon, its 13 boxes issued at once).  The loop
// (fmpc_group_backward) is K10's too (fmpc_backward_packed.cuh, TMA chunks
// of the packed buffer, which holds the scalings): the two differ in the
// feed and in where the scalings come from.

#pragma once

#include "ddp_backward.cuh"
#include "fmpc_group.cuh"
#include "fmpc_stage.cuh"

namespace nmpc {

// The carry's inputs and the flags of a run: s_T [NX, B] (K8 takes
// Lx_bar_term and negates it), P_T [NX, NX, B]; ok and finite one byte
// per lane.
template <typename T>
struct FmpcRun {
  const T* __restrict__ sT;
  const T* __restrict__ PT;
  bool negate_sT;
  T dt;
  bool break_if_llt_fails, check_nan;
  unsigned char* __restrict__ ok;
  unsigned char* __restrict__ finite;
};

// Where the outputs go: value e of k, K, s or P of stage i of lane b at
// its pointer + i * its stage stride + e * B + b (K8: the four arrays;
// K10: the [N, Fout, B] buffer); `terminal`: also write (s_T, P_T) as row
// N.
template <typename T>
struct FmpcSink {
  T* __restrict__ k;
  T* __restrict__ K;
  T* __restrict__ s;
  T* __restrict__ P;
  size_t stage_k, stage_K, stage_s, stage_P;
  bool terminal;
};

// Store the own rows of the carry's s and P at row i, and AND their
// finiteness into `fin`.
template <typename T, int NX, int G>
__device__ __forceinline__ void store_carry_rows(const FmpcCarry<T, NX>& c,
                                                 const FmpcSink<T>& out,
                                                 int i, int b, int B,
                                                 bool store, bool& fin) {
  const int r = LaneGroup<G>::rank();
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    if (a % G != r) continue;
    fin = fin && finite(c.s[a]);
    if (store) out.s[i * out.stage_s + static_cast<size_t>(a) * B + b] = c.s[a];
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      fin = fin && finite(c.P[a][e]);
      if (store)
        out.P[i * out.stage_P + static_cast<size_t>(a * NX + e) * B + b] =
            c.P[a][e];
    }
  }
}

// The recursion of one lane's group over chunks of C stages from the end
// of the horizon (row_group.cuh::packed_chunk): `feed.acquire(c)` makes
// chunk c readable by the whole warp and returns this lane's column of
// its buffer, `stage_of(slab, s, i)` the fields of its stage s (stage i
// of the horizon), the condensation scalings among them (K8 forms them
// here: FoldedStages); each stage runs fmpc_stage_group and the
// group stores its outputs (rank 0 k, each thread its own rows and
// columns); the finite flag is the AND over the group of every value
// written (and the terminal row), rank 0 stores it and ok.  Every thread
// of a warp calls it (a warp wholly past the batch has returned).
template <typename T, int NX, int NU, int NG, int G, bool SHARE,
          typename Feed, typename StageOf>
__device__ __forceinline__ void fmpc_group_backward(
    Feed& feed, const StageOf& stage_of, const GroupLane<G>& at, int N,
    int C, int B, const FmpcRun<T>& run, const FmpcSink<T>& out) {
  constexpr int J = (NX + G - 1) / G;
  const int r = LaneGroup<G>::rank();
  const int b = at.b;
  FmpcCarry<T, NX> c;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    const T v = run.sT[static_cast<size_t>(a) * B + b];
    c.s[a] = run.negate_sT ? -v : v;
#pragma unroll
    for (int e = 0; e < NX; ++e)
      c.P[a][e] = run.PT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  c.ok = true;
  bool fin = true;
  store_carry_rows<T, NX, G>(c, out, N, b, B, at.live && out.terminal, fin);
  const int n = packed_chunks(N, C);
  for (int ci = 0; ci < n; ++ci) {
    const T* slab = feed.acquire(ci);
    const PackedChunk chunk = packed_chunk(ci, N, C);
    for (int i = chunk.hi - 1; i >= chunk.lo; --i) {
      T k[NU], Kc[J][NU];
      fmpc_stage_group<T, NX, NU, NG, G, SHARE>(
          stage_of(slab, i - chunk.start, i), run.dt,
          run.break_if_llt_fails, c, k, Kc);
      if (r == 0) {
#pragma unroll
        for (int m = 0; m < NU; ++m) {
          fin = fin && finite(k[m]);
          if (at.live)
            out.k[i * out.stage_k + static_cast<size_t>(m) * B + b] = k[m];
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int a = j * G + r;
        if (a >= NX) continue;
#pragma unroll
        for (int m = 0; m < NU; ++m) {
          fin = fin && finite(Kc[j][m]);
          if (at.live)
            out.K[i * out.stage_K + static_cast<size_t>(m * NX + a) * B + b] =
                Kc[j][m];
        }
      }
      store_carry_rows<T, NX, G>(c, out, i, b, B, at.live, fin);
    }
  }
  const bool all_finite = LaneGroup<G>::ballot(fin) == LaneGroup<G>::kBits;
  if (at.live && r == 0) {
    run.ok[b] = c.ok ? 1 : 0;
    run.finite[b] = (all_finite || !run.check_nan) ? 1 : 0;
  }
}

// K8's and K9's stages: the fields of stage s of a chunk of n stages
// (stage i of the horizon), with the scalings the lane's group forms from
// them, its mask row (stage i's at gms + i * gms_ld: 0 where every stage
// has the same mask) and the lane's eps.
template <typename T, int NX, int NU, int NG, int G, typename Layout, int CH>
struct FoldedStages {
  const T* __restrict__ gms;
  int gms_ld, stride, n;
  T eps;
  __device__ CondensedStageFields<
      T, NG, ChunkStageFields<T, NX, NU, NG, Layout, CH>>
  operator()(const T* slab, int s, int i) const {
    CondensedStageFields<T, NG, ChunkStageFields<T, NX, NU, NG, Layout, CH>>
        f{{slab, s, stride, n}, {}, {}};
    fmpc_condense_group<T, NG, G>(f, gms + static_cast<size_t>(i) * gms_ld,
                                  eps, f.scale, f.shift);
    return f;
  }
};

// K8's tensor maps, one per field ([N, size, B]: A, B, C, D, Lxx, Luu,
// Lxu, x_bar, Lx_bar, Lu_bar, s, nu, g_bar; fmpc_group.cuh::kFmpcFields).
struct FmpcMaps {
  CUtensorMap field[kFmpcFields];
};

// A block: L lanes of G threads (the consumer warps), then one producer
// warp.  CH > 0 (K8): a ring of kFmpcRing buffers of CH stages; CH = 0
// (K9): one buffer of the whole horizon, a single chunk of N stages.
template <typename T, int NX, int NU, int NG, int G, bool SHARE, int CH>
__global__ void __launch_bounds__(kMaxRowLanes * G + 32)
fmpc_backward_kernel(const __grid_constant__ FmpcMaps maps,
                     const T* __restrict__ gms, int gms_ld,
                     const T* __restrict__ eps, FmpcRun<T> run,
                     FmpcSink<T> out, int N, int B) {
  using Layout = FmpcStreamLayout<T, NX, NU, NG, G>;
  using Layout1 = FmpcLayout<NX, NU, NG, false, 1>;   // unpadded
  constexpr int W = 32 / G;
  constexpr int R = CH > 0 ? kFmpcRing : 1;
  const int C = CH > 0 ? CH : N;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = (static_cast<int>(blockDim.x) - 32) / G;
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  const StageRing<T, R> ring(smem_raw, packed_buffer_bytes<T>(C, Layout::F,
                                                              L));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], (lanes + W - 1) / W);   // warps with lanes
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= L * G) {       // the producer warp
    // thread f < 13 issues field f's box of every chunk; thread 0 first
    // waits until every consumer warp left the buffer and arms its full
    // barrier
    constexpr int offset[kFmpcFields] = {
        Layout::A,  Layout::Bm,  Layout::C,   Layout::D,  Layout::Lxx,
        Layout::Luu, Layout::Lxu, Layout::xb, Layout::Lxb, Layout::Lub,
        Layout::ss, Layout::nu,  Layout::gbar};
    const int f = static_cast<int>(threadIdx.x % 32);
    const int at_f = f < kFmpcFields ? offset[f] * C * L : 0;
    const int n = packed_chunks(N, C);
    for (int c = 0; c < n; ++c) {
      const int s = c % R;
      if (f == 0) {
        if (c >= R)
          mbar_wait(&ring.empty[s], static_cast<uint32_t>((c / R - 1) & 1));
        mbar_arm(&ring.full[s],
                 static_cast<uint32_t>(C * Layout1::F * L * sizeof(T)));
      }
      __syncwarp();
      if (f < kFmpcFields)
        tma_load_3d(maps.field[f], &ring.full[s],
                    ring.buffers + s * ring.buffer + at_f, base, 0,
                    packed_chunk(c, N, C).start);
    }
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  StageRingFeed<T, R> feed{ring, at.b - base, L};
  const FoldedStages<T, NX, NU, NG, G, Layout, CH> stage_of{
      gms, gms_ld, L, C, eps[at.b]};
  fmpc_group_backward<T, NX, NU, NG, G, SHARE>(feed, stage_of, at, N, C, B,
                                               run, out);
}

// One launch of fmpc_backward_kernel with L lanes a block and chunks of C
// stages (CH as the kernel's; C = N where CH = 0); the arguments as
// launch_fmpc_backward's.  Returns a CUDA error code: of a field's tensor
// map (tma.cuh::encode_map_3d), of the shared-memory attribute, or
// cudaGetLastError() after the launch.
template <typename T, int NX, int NU, int NG, int G, bool SHARE, int CH>
int launch_fmpc_group(int L, int C, int N, int B, int ld, double dt,
                      int break_if_llt_fails, int check_nan,
                      const void* const* fields, const void* gms, int gms_ld,
                      const void* eps, const void* LxT, const void* PT,
                      void* ks, void* Ks, void* sv, void* Ps, void* ok,
                      void* finite, void* stream) {
  using Layout = FmpcStreamLayout<T, NX, NU, NG, G>;
  const int sizes[kFmpcFields] = {NX * NX, NX * NU, NG * NX, NG * NU,
                                  NX * NX, NU * NU, NX * NU, NX,
                                  NX,      NU,      NG,      NG, NG};
  FmpcMaps maps;
  for (int f = 0; f < kFmpcFields; ++f) {
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, sizes[f],
                                     N, ld, L, sizes[f], C);
    if (err != 0) return err;
  }
  const size_t smem = ring_bytes<T>(CH > 0 ? kFmpcRing : 1, C, Layout::F, L);
  if (smem > kMaxBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_dynamic_smem(
      fmpc_backward_kernel<T, NX, NU, NG, G, SHARE, CH>, smem);
  if (err != 0) return err;
  const size_t b = static_cast<size_t>(B);
  const FmpcRun<T> run{static_cast<const T*>(LxT),
                       static_cast<const T*>(PT),
                       true,
                       static_cast<T>(dt),
                       break_if_llt_fails != 0,
                       check_nan != 0,
                       static_cast<unsigned char*>(ok),
                       static_cast<unsigned char*>(finite)};
  const FmpcSink<T> out{static_cast<T*>(ks), static_cast<T*>(Ks),
                        static_cast<T*>(sv), static_cast<T*>(Ps),
                        NU * b, NU * NX * b, NX * b, NX * NX * b, true};
  fmpc_backward_kernel<T, NX, NU, NG, G, SHARE, CH>
      <<<(B + L - 1) / L, L * G + 32, smem,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<const T*>(gms), gms_ld,
          static_cast<const T*>(eps), run, out, N, B);
  return static_cast<int>(cudaGetLastError());
}

// K8's launch on `stream`; returns a CUDA error code (launch_fmpc_group).
// fields: A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, s, nu, g_bar,
// each batch-minor [N, size, B] with its lanes ld values apart (ld *
// sizeof(T) and each address multiples of 16 bytes); gms [N, NG], its rows
// gms_ld values apart (0: one mask row for every stage), eps [B], LxT
// (Lx_bar_term: s_T = -LxT) [NX, B], PT [NX, NX, B] contiguous; ks [N, NU,
// B], Ks [N, NU, NX, B], sv [N + 1, NX, B], Ps [N + 1, NX, NX, B]; ok and
// finite one byte per lane.  G threads per lane and SHARE as
// fmpc_stage_group (fmpc_group.cuh's rules unless a measurement asks for
// others).
template <typename T, int NX, int NU, int NG, int G = kFmpcGroup<NX, NU>,
          bool SHARE = kFmpcShare<NX>>
int launch_fmpc_backward(int N, int B, int ld, double dt,
                         int break_if_llt_fails, int check_nan,
                         const void* const* fields, const void* gms,
                         int gms_ld, const void* eps, const void* LxT, const void* PT,
                         void* ks, void* Ks, void* sv, void* Ps, void* ok,
                         void* finite, void* stream) {
  using Layout = FmpcStreamLayout<T, NX, NU, NG, G>;
  constexpr int CH = fmpc_stream_chunk<T>(Layout::F);
  constexpr int least = (32 / G) > 4 ? 32 / G : 4;
  static_assert(ring_bytes<T>(kFmpcRing, CH, Layout::F, least) <=
                    kMaxBlockSmem,
                "a block's ring of chunk buffers passes its shared memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fmpc_group<T, NX, NU, NG, G, SHARE, CH>(
      fmpc_stream_lanes<T, G>(Layout::F, B), CH, N, B, ld, dt,
      break_if_llt_fails, check_nan, fields, gms, gms_ld, eps, LxT, PT, ks,
      Ks, sv, Ps, ok, finite, stream);
}

}  // namespace nmpc

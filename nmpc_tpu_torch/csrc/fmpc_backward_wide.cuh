// K8 and K9 at the wide shapes: the FMPC condensed primal-dual Riccati
// backward for Hopper (sm_90a) where (NX, NU, NG) passes the narrow
// kernels' sizes (fmpc_group.cuh::kFmpcWide: nx > 8, nu > 4 or ng > 16;
// the oscillating masses' (12, 3, 30)), up to (16, 16, 64).  Its loop
// (fmpc_wide_backward) is K10's there too (fmpc_backward_packed_wide.cuh).
//
// Replaces the TPU kernels nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call (:558, K8) and _fmpc_backward_pallas_call_
// resident (:515, K9) at those shapes, as fmpc_backward.cuh and
// fmpc_backward_resident.cuh do at the others: the same inputs (the ten
// coefficient fields, s, nu and g_bar [N, size, B], the masks [N, NG], eps
// [B], the terminal Lx_bar and P), the same outputs (k, K, the N + 1 rows
// of s and P, ok, finite), the (s, nu) condensation formed in the kernel
// (fmpc_stage.cuh::fmpc_condense).  Its plain version is nmpc_tpu_torch/
// solvers/fmpc.py::_backward_bm; the wrapper (kernels/fmpc_backward.py)
// builds this header's launches for a wide shape.
//
// What bounds it on the card: each lane's chain of N dependent stages,
// and the feed of its fields.  At (12, 3, 30) a stage reads 936 values and
// writes 195 a lane (556 MB at B = 4096, N = 30, fp32: 0.17 ms at 3.35
// TB/s); between them ~29,000 operations, ~18,000 of them the
// condensation's NG-term sums, which the lane's threads share, in a chain
// of NU + 7 exchanges of the group.  The fields arrive by TMA boxes whose
// rows are a block's lanes of one value, B values apart in device memory:
// the issue of a box costs the issuing thread ~32 cycles a row, so one
// thread issuing a stage's boxes for 4 lanes took ~31,000 cycles a stage,
// three times the stage (the profile build below; PERF.md, section 6).
//
// What the design does about it: K1-wide's block (ddp_backward_wide.cuh):
// L lanes of G threads running fmpc_stage_wide.cuh's stage, each lane's
// scratch in the block's dynamic shared memory after the stage buffers
// (WideFmpcBlock: its lanes, ring and scratch; G and L by fmpc_group.cuh's
// rules: at the masses 4 lanes of 16 threads at fp32, 2 of 32 at fp64, a
// box row of 16 bytes, so that a warp's reads of a stage's values spread
// over the banks, and 43,392 bytes a block, four blocks an SM); one
// producer warp (the block's last) fills a ring of kFmpcWideRing one-stage
// buffers from the end of the horizon (a full and an empty mbarrier a
// buffer), its threads issuing a stage's boxes together, box k by thread
// k: one tensor map a field, a field of more than 256 values in pieces
// (FmpcWideLayout: C at the masses in two boxes of 184 values, 14 boxes a
// stage), each landing 128-byte aligned.  K9 (RESIDENT) is the same
// kernel with the whole horizon's N one-stage buffers (a lane a warp, the
// block's lanes by FmpcWideRule::resident_lanes: up to 4, the most whose
// horizon fits), a full barrier each, every box of the
// horizon issued at once by the producer warp's 32 threads from the last
// stage, so that the lanes start on it as soon as it lands; it takes N <=
// 32 where those buffers and the lanes' scratch fit
// (FmpcWideRule::resident_fits: the masses up to N = 14).  One kernel for
// each lane count, so that every field's address is the slab's plus an
// immediate.  TMA takes a field at a 16-byte aligned address with its
// lanes a multiple of 16 bytes apart: the wrapper copies any other field
// once (kernels/fmpc_backward.py::tma_fields); lanes past B arrive zero-
// filled, a lane past the batch's end runs the last lane's column and
// stores nothing, a warp wholly past it returns at once.  The profile
// build (P) stores clock64() cycles of each part of a lane's stage
// (fmpc_stage_wide.cuh::FmpcWidePhase) and of the producer's waits and
// issues; every solver launch is the normal build.

#pragma once

#include "ddp_backward_wide.cuh"
#include "fmpc_backward.cuh"
#include "fmpc_stage_wide.cuh"

namespace nmpc {

// The recursion of one lane's group on the wide stage: the terminal carry
// into the lane's scratch `s` (its row N stored where out.terminal, and
// in the finite flag), then the chunks of C stages from the end of the
// horizon (row_group.cuh::packed_chunk; `feed.acquire(c)` gives this
// lane's column of chunk c's buffer, `stage_of(slab, s, i)` the fields of
// its stage s, stage i of the horizon), each stage's k, K, s and P stored
// by the group (value q by rank q % G) and ANDed into the finite flag;
// rank 0 stores ok and finite.  Every thread of a warp calls it (a warp
// wholly past the batch has returned).  The profile build (P) also stores
// each (stage, lane)'s cycles of each FmpcWidePhase at prof[(q N + i) B
// + b] (the wait where a chunk's buffer is waited for, 0 elsewhere).
template <typename T, int NX, int NU, int NG, int G, bool P = false,
          typename Feed, typename StageOf>
__device__ __forceinline__ void fmpc_wide_backward(
    Feed& feed, const StageOf& stage_of, const GroupLane<G>& at, int N,
    int C, int B, const FmpcRun<T>& run, const FmpcSink<T>& out, T* s,
    long long* __restrict__ prof = nullptr) {
  using S = WideFmpcScratch<NX, NU, NG>;
  const int r = LaneGroup<G>::rank();
  FmpcClock<P> clk;
  const size_t b = static_cast<size_t>(at.b);
  bool fin = true;
  // the carry's s and P together from S::s: value e < NX of s, then P
  auto store_carry = [&](int i, bool store) {
    for (int e = r; e < NX + NX * NX; e += G) {
      const T v = s[S::s + e];
      fin = fin && finite(v);
      if (!store) continue;
      if (e < NX)
        out.s[i * out.stage_s + static_cast<size_t>(e) * B + b] = v;
      else
        out.P[i * out.stage_P + static_cast<size_t>(e - NX) * B + b] = v;
    }
  };
  for (int e = r; e < NX + NX * NX; e += G) {
    if (e < NX) {
      const T v = run.sT[static_cast<size_t>(e) * B + b];
      s[S::s + e] = run.negate_sT ? -v : v;
    } else {
      s[S::s + e] = run.PT[static_cast<size_t>(e - NX) * B + b];
    }
  }
  store_carry(N, at.live && out.terminal);
  __syncwarp();
  bool ok = true;
  const int n = packed_chunks(N, C);
  for (int c = 0; c < n; ++c) {
    clk.start();
    const T* slab = feed.acquire(c);
    clk.lap(kFwWait);
    const PackedChunk chunk = packed_chunk(c, N, C);
    for (int i = chunk.hi - 1; i >= chunk.lo; --i) {
      fmpc_stage_wide<T, NX, NU, NG, G>(stage_of(slab, i - chunk.start, i),
                                       run.dt, run.break_if_llt_fails, s,
                                       ok, clk);
      // k and K from s[X] (row m: k[m], then K[m][a])
      for (int q = r; q < NU * (NX + 1); q += G) {
        const int m = q / (NX + 1), col = q % (NX + 1);
        const T v = s[S::X + m * S::XS + col];
        fin = fin && finite(v);
        if (!at.live) continue;
        if (col == 0)
          out.k[i * out.stage_k + static_cast<size_t>(m) * B + b] = v;
        else
          out.K[i * out.stage_K + static_cast<size_t>(m * NX + col - 1) * B +
                b] = v;
      }
      store_carry(i, at.live);
      clk.lap(kFwStore);
      if constexpr (P) {
        if (at.live && r == 0) {
#pragma unroll
          for (int q = 0; q < kFmpcWidePhases; ++q)
            prof[(static_cast<size_t>(q) * N + i) * B + b] = clk.acc[q];
        }
        clk.start();
      }
    }
  }
  const bool all_finite = LaneGroup<G>::ballot(fin) == LaneGroup<G>::kBits;
  if (at.live && r == 0) {
    run.ok[b] = ok ? 1 : 0;
    run.finite[b] = (all_finite || !run.check_nan) ? 1 : 0;
  }
}

// K8's and K9's wide stage: one stage's slab of the block's L lanes
// (value e of a field at p[(offset + e) L]), the stage's mask row and the
// lane's eps, from which the group forms the (s, nu) scalings.
template <typename T, int NX, int NU, int NG, int L>
struct WideFoldedStage {
  using O = FmpcWideLayout<NX, NU, NG>;
  const T* __restrict__ p;
  const T* __restrict__ gm;
  T eps;
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
    fmpc_condense<T>(at(O::ss, g), at(O::nu, g), at(O::gbar, g),
                     gm[g] > T(0), eps, nu_s, tilde);
  }
};

// Issue box k of stage i's fields (field by field, each field's pieces in
// order) into the stage's slot `dst` of L lanes, on `bar`.
template <typename T, int NX, int NU, int NG, int L>
__device__ __forceinline__ void issue_wide_box(const FmpcMaps& maps, int k,
                                               T* dst, uint64_t* bar,
                                               int base, int i) {
  int f = 0;
  int pieces = fmpc_wide_pieces(fmpc_field_size(NX, NU, NG, 0));
  while (k >= pieces) {
    k -= pieces;
    ++f;
    pieces = fmpc_wide_pieces(fmpc_field_size(NX, NU, NG, f));
  }
  const int box = fmpc_wide_box(fmpc_field_size(NX, NU, NG, f));
  tma_load_3d(maps.field[f], bar,
              dst + (fmpc_wide_offset(NX, NU, NG, f) + k * box) * L, base,
              k * box, i);
}

// A consumer warp's side of the block's one-stage buffers (`buffer`
// values each, this lane's column at `col`): K8's ring of R buffers, a
// full and an empty barrier each (stage c from the end in buffer c % R,
// its (c / R)-th use; the warp arrives once on the empty barrier of the
// stage it is done with), K9's N buffers of the horizon, a full barrier
// each (stage c from the end in buffer c, used once).
template <typename T, bool RESIDENT>
struct WideStageFeed {
  uint64_t* full;
  uint64_t* empty;
  const T* buffers;
  int R, buffer, col;

  __device__ const T* acquire(int c) {
    const int q = RESIDENT ? c : c % R;
    if (!RESIDENT && c > 0) {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[(c - 1) % R]);
    }
    mbar_wait(&full[q], RESIDENT ? 0u : static_cast<uint32_t>((c / R) & 1));
    return buffers + static_cast<size_t>(q) * buffer + col;
  }
};

// A block: L lanes of G threads (the consumer warps), then one producer
// warp; K8 (RESIDENT = false) a ring of R one-stage buffers after 128
// bytes of barriers, K9 the horizon's N one-stage buffers after N full
// barriers (FmpcWideRule::bytes, resident_bytes); the lanes' scratch
// after them.  The producer warp's threads issue a stage's boxes
// together, box k by thread k % 32, once its first thread armed the
// stage's barrier: K8 a stage at a time, each after every thread saw its
// buffer emptied; K9 the horizon's boxes at once, from its last stage.
// The profile build (P) stores the lanes' cycles a phase
// (fmpc_wide_backward) and, after them at prof + kFmpcWidePhases N B, the
// producer's cycles of stage c from the end ([2][N][blocks]): the wait
// for its empty buffer at [c][block], the issue of its boxes at [N +
// c][block] (K9: the horizon's at [N][block]).
template <typename T, int NX, int NU, int NG, int G, int L, bool RESIDENT,
          bool P>
__global__ void __launch_bounds__(L * G + 32)
fmpc_backward_wide_kernel(const __grid_constant__ FmpcMaps maps,
                          const T* __restrict__ gms, int gms_ld,
                          const T* __restrict__ eps, FmpcRun<T> run,
                          FmpcSink<T> out, int N, int B, int R,
                          long long* __restrict__ prof) {
  using O = FmpcWideLayout<NX, NU, NG>;
  using Block = WideFmpcBlock<T, NX, NU, NG, G>;
  constexpr int W = 32 / G;
  constexpr int buffer = O::F * L;   // values, a multiple of 128 bytes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const int lanes = B - base < L ? B - base : L;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + R;
  T* buffers = reinterpret_cast<T*>(smem_raw + (RESIDENT ? round_up(8 * N, 128)
                                                         : 128));
  if (threadIdx.x == 0) {
    for (int q = 0; q < R; ++q) {
      mbar_init(&full[q]);
      if (!RESIDENT) mbar_init(&empty[q], (lanes + W - 1) / W);   // warps
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= L * G) {       // the producer warp
    const int t = static_cast<int>(threadIdx.x % 32);
    const uint32_t bytes = static_cast<uint32_t>(buffer * sizeof(T));
    [[maybe_unused]] const int blocks = (B + L - 1) / L;
    long long* lap =
        P ? prof + static_cast<size_t>(kFmpcWidePhases) * N * B + blockIdx.x
          : nullptr;
    if (RESIDENT) {
      const long long t0 = P ? clock64() : 0;
      if (t == 0)
        for (int c = 0; c < N; ++c) mbar_arm(&full[c], bytes);
      __syncwarp();
      for (int k = t; k < N * O::boxes; k += 32) {
        const int c = k / O::boxes;
        issue_wide_box<T, NX, NU, NG, L>(
            maps, k % O::boxes, buffers + static_cast<size_t>(c) * buffer,
            &full[c], base, N - 1 - c);
      }
      if constexpr (P) {
        __syncwarp();
        if (t == 0) {
          lap[0] = 0;
          lap[static_cast<size_t>(N) * blocks] = clock64() - t0;
        }
      }
      return;
    }
    for (int c = 0; c < N; ++c) {
      const int q = c % R;
      const long long t0 = P ? clock64() : 0;
      if (c >= R)
        mbar_wait(&empty[q], static_cast<uint32_t>((c / R - 1) & 1));
      const long long t1 = P ? clock64() : 0;
      if (t == 0) mbar_arm(&full[q], bytes);
      __syncwarp();
      for (int k = t; k < O::boxes; k += 32)
        issue_wide_box<T, NX, NU, NG, L>(
            maps, k, buffers + static_cast<size_t>(q) * buffer, &full[q],
            base, N - 1 - c);
      if constexpr (P) {
        __syncwarp();
        if (t == 0) {
          lap[static_cast<size_t>(c) * blocks] = t1 - t0;
          lap[static_cast<size_t>(N + c) * blocks] = clock64() - t1;
        }
      }
    }
    return;
  }
  const GroupLane<G> at(B, L);
  if (at.lane0 >= B) return;                // a warp wholly past the batch
  T* scratch = reinterpret_cast<T*>(
                   reinterpret_cast<unsigned char*>(buffers) +
                   static_cast<size_t>(R) * buffer * sizeof(T)) +
               static_cast<size_t>(threadIdx.x / G) * Block::stride;
  WideStageFeed<T, RESIDENT> feed{full, empty, buffers, R, buffer,
                                  at.b - base};
  const T lane_eps = eps[at.b];
  auto stage_of = [gms, gms_ld, lane_eps](const T* slab, int, int i) {
    return WideFoldedStage<T, NX, NU, NG, L>{
        slab, gms + static_cast<size_t>(i) * gms_ld, lane_eps};
  };
  fmpc_wide_backward<T, NX, NU, NG, G, P>(feed, stage_of, at, N, 1, B, run,
                                          out, scratch, prof);
}

// One launch of fmpc_backward_wide_kernel (K8: lanes = 0, K8's rule; K9
// (RESIDENT): lanes = 0, resident_lanes, or that many); the arguments and
// the result as fmpc_backward.cuh::launch_fmpc_backward's
// (cudaErrorInvalidValue where the block does not fit its shared memory,
// K9's horizon included, or `lanes` is not one a block takes); the
// profile build (P) stores its cycles at `prof` (long long [kFmpcWide
// Phases N B + 2 N B]).
template <typename T, int NX, int NU, int NG, int G, bool RESIDENT, bool P>
int launch_fmpc_wide(int lanes, int N, int B, int ld, double dt,
                     int break_if_llt_fails, int check_nan,
                     const void* const* fields, const void* gms, int gms_ld,
                     const void* eps, const void* LxT, const void* PT,
                     void* ks, void* Ks, void* sv, void* Ps, void* ok,
                     void* finite, void* stream, void* prof) {
  using Block = WideFmpcBlock<T, NX, NU, NG, G>;
  constexpr FmpcWideRule<T> rule = Block::rule();
  constexpr int most =
      RESIDENT ? Block::resident_max_lanes : Block::max_lanes;
  static_assert(most * G + 32 <= 1024, "a wide block passes 1024 threads");
  if (B <= 0 || N <= 0 || !rule.fits() ||
      (RESIDENT && !rule.resident_fits(N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = lanes > 0 ? lanes
                : RESIDENT ? rule.resident_lanes(N, B)
                           : most;
  const int R = RESIDENT ? N : Block::ring;
  if ((RESIDENT ? rule.resident_bytes(N, L) : rule.bytes(R, L)) >
      kMaxBlockSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  FmpcMaps maps;
  for (int f = 0; f < kFmpcFields; ++f) {
    const int size = fmpc_field_size(NX, NU, NG, f);
    const int err = encode_map_3d<T>(&maps.field[f], fields[f], B, size, N,
                                     ld, L, fmpc_wide_box(size), 1);
    if (err != 0) return err;
  }
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
  return with_lanes<Block::least, most>(L, [&](auto lanes_c) {
    constexpr int LL = decltype(lanes_c)::value;
    const size_t smem =
        RESIDENT ? rule.resident_bytes(N, LL) : rule.bytes(R, LL);
    const int err = allow_dynamic_smem(
        fmpc_backward_wide_kernel<T, NX, NU, NG, G, LL, RESIDENT, P>, smem);
    if (err != 0) return err;
    fmpc_backward_wide_kernel<T, NX, NU, NG, G, LL, RESIDENT, P>
        <<<(B + LL - 1) / LL, LL * G + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
            maps, static_cast<const T*>(gms), gms_ld,
            static_cast<const T*>(eps), run, out, N, B, R,
            static_cast<long long*>(prof));
    return static_cast<int>(cudaGetLastError());
  });
}

// K8-wide's launch on `stream`; the arguments and the result as
// fmpc_backward.cuh::launch_fmpc_backward's.  G threads a lane as
// kFmpcWideStreamGroup unless a test asks for another; the profile build
// (P, in no launch of the solver) stores its cycles at `prof`
// (launch_fmpc_wide).
template <typename T, int NX, int NU, int NG,
          int G = kFmpcWideStreamGroup<T>, bool P = false>
int launch_fmpc_backward_wide(int N, int B, int ld, double dt,
                              int break_if_llt_fails, int check_nan,
                              const void* const* fields, const void* gms,
                              int gms_ld, const void* eps, const void* LxT,
                              const void* PT, void* ks, void* Ks, void* sv,
                              void* Ps, void* ok, void* finite,
                              void* stream, void* prof = nullptr) {
  static_assert(G != kFmpcWideStreamGroup<T> ||
                    WideFmpcBlock<T, NX, NU, NG, G>::rule().fits(),
                "a wide block of the fewest lanes passes its shared memory");
  return launch_fmpc_wide<T, NX, NU, NG, G, false, P>(
      0, N, B, ld, dt, break_if_llt_fails, check_nan, fields, gms,
      gms_ld, eps, LxT, PT, ks, Ks, sv, Ps, ok, finite, stream, prof);
}

// K9-wide's launch on `stream` with `lanes` lanes a block (0: its rule);
// the arguments and the result as launch_fmpc_backward_resident's; P and
// `prof` as K8-wide's.
template <typename T, int NX, int NU, int NG, int G = kFmpcWideGroup,
          bool P = false>
int launch_fmpc_backward_resident_wide(
    int lanes, int N, int B, int ld, double dt, int break_if_llt_fails,
    int check_nan, const void* const* fields, const void* gms, int gms_ld,
    const void* eps, const void* LxT, const void* PT, void* ks, void* Ks,
    void* sv, void* Ps, void* ok, void* finite, void* stream,
    void* prof = nullptr) {
  return launch_fmpc_wide<T, NX, NU, NG, G, true, P>(
      lanes, N, B, ld, dt, break_if_llt_fails, check_nan, fields, gms,
      gms_ld, eps, LxT, PT, ks, Ks, sv, Ps, ok, finite, stream, prof);
}

}  // namespace nmpc

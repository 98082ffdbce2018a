// The lane-group geometry of the FMPC condensed Riccati backward kernels
// that run fmpc_stage.cuh::fmpc_stage_group: the streaming one (K8,
// fmpc_backward.cuh), the resident one (K9, fmpc_backward_resident.cuh)
// and the packed one (K10, fmpc_backward_packed.cuh).  A block holds L
// lanes of G threads each (thread t is rank t % G of the block's lane t /
// G), as row_group.cuh lays out the DDP kernels, and each kernel keeps its
// stages in shared memory: K8 a ring of two chunk buffers per block
// (filled by a producer warp), K9 one buffer of the block's whole horizon
// (filled the same way), K10 a ring of kPackedRing chunk buffers per
// warp.  Here: the
// threads per lane, the fields of a stage and their offsets in each
// kernel's buffers, and the rules that keep a launch within a block's
// shared memory at every (NX <= 8, NU <= 4, NG <= 16); past those, the
// same for the wide units (fmpc_backward_wide.cuh, fmpc_backward_packed_
// wide.cuh: fmpc_stage_wide.cuh's stage on one lane a warp) up to (16,
// 16, 64).  Every rule is a host-and-device function, so the launch and
// the kernel compute it alike.

#pragma once

#include "row_group.cuh"

namespace nmpc {

// Threads per lane of fmpc_stage_group, and whether the group exchanges
// its rows of P A, P B and P x_bar (share) or every thread computes them,
// chosen by measurement on the H100 among G = 1, 2, 4, 8 at the
// cart-pole's (4, 1, 4) and 1, 2, 4 at the oscillator's (2, 1, 3), each
// with and without share (chip_smoke.py --qp-groups; PERF.md, Findings):
//   K8 (kFmpcGroup): 4 at both, where it also splits the condensation's
//     rows (8 at (4, 1, 4) idles half its ranks, 1 and 2 leave the
//     oscillator's divisions on fewer threads);
//   K10 (kFmpcPackedGroup): 4 at (4, 1, 4), 2 at (2, 1, 3) (its stage
//     reads the scalings, and 4 threads on two rows only add exchanges);
//   share at nx >= 4 (kFmpcShare; level with computing the rows at (2, 1,
//     3), 1-3 % faster at (4, 1, 4) fp64).
// Other shapes follow the nearest measured one: nx >= 4 as (4, 1, 4),
// nx < 4 as (2, 1, 3).
__host__ __device__ constexpr int fmpc_group(int, int) { return 4; }
__host__ __device__ constexpr int fmpc_packed_group(int nx, int) {
  return nx >= 4 ? 4 : 2;
}
template <int NX, int NU>
constexpr int kFmpcGroup = fmpc_group(NX, NU);
template <int NX, int NU>
constexpr int kFmpcPackedGroup = fmpc_packed_group(NX, NU);
template <int NX>
constexpr bool kFmpcShare = NX >= 4;

__host__ __device__ constexpr int round_up(int v, int q) {
  return (v + q - 1) / q * q;
}

// The offsets of one stage's fields, each row-major, each rounded up to a
// multiple of q values: the ten coefficient fields A, B, C, D, Lxx, Luu,
// Lxu, x_bar, Lx_bar, Lu_bar, then
//   * K8's stage (packed = false): s, nu and g_bar, the inputs of the
//     (s, nu) condensation the kernel folds in;
//   * the packed stage (packed = true, q = 1): nu/s and tilde, the
//     condensed scalings (fmpc_backward_pallas.py::_field_offsets; Fin =
//     78 at the cart-pole's (4, 1, 4)), and the packed outputs k, K, s, P
//     (Fout = 25 there).
// F is the stage's values (rounded up to q).
struct FmpcOffsets {
  int A, Bm, C, D, Lxx, Luu, Lxu, xb, Lxb, Lub;
  int ss, nu, gbar, nu_s, tilde;
  int F;
  int k, K, s, P, Fout;
};

__host__ __device__ constexpr FmpcOffsets fmpc_offsets(int nx, int nu,
                                                       int ng, bool packed,
                                                       int q) {
  FmpcOffsets o{};
  o.A = 0;
  o.Bm = round_up(o.A + nx * nx, q);
  o.C = round_up(o.Bm + nx * nu, q);
  o.D = round_up(o.C + ng * nx, q);
  o.Lxx = round_up(o.D + ng * nu, q);
  o.Luu = round_up(o.Lxx + nx * nx, q);
  o.Lxu = round_up(o.Luu + nu * nu, q);
  o.xb = round_up(o.Lxu + nx * nu, q);
  o.Lxb = round_up(o.xb + nx, q);
  o.Lub = round_up(o.Lxb + nx, q);
  const int rest = round_up(o.Lub + nu, q);
  if (packed) {
    o.nu_s = rest;
    o.tilde = round_up(o.nu_s + ng, q);
    o.F = round_up(o.tilde + ng, q);
    o.ss = o.nu = o.gbar = -1;
  } else {
    o.ss = rest;
    o.nu = round_up(o.ss + ng, q);
    o.gbar = round_up(o.nu + ng, q);
    o.F = round_up(o.gbar + ng, q);
    o.nu_s = o.tilde = -1;
  }
  o.k = 0;
  o.K = nu;
  o.s = o.K + nu * nx;
  o.P = o.s + nx;
  o.Fout = o.P + nx * nx;
  return o;
}

template <int NX, int NU, int NG, bool PACKED, int Q>
struct FmpcLayout {
  static constexpr FmpcOffsets o = fmpc_offsets(NX, NU, NG, PACKED, Q);
  static constexpr int A = o.A, Bm = o.Bm, C = o.C, D = o.D, Lxx = o.Lxx,
                       Luu = o.Luu, Lxu = o.Lxu, xb = o.xb, Lxb = o.Lxb,
                       Lub = o.Lub, ss = o.ss, nu = o.nu, gbar = o.gbar,
                       nu_s = o.nu_s, tilde = o.tilde, F = o.F, k = o.k,
                       K = o.K, s = o.s, P = o.P, Fout = o.Fout;
};

// The packed stage of K10 and K9: inputs [Fin = F] and outputs [Fout].
template <int NX, int NU, int NG>
using FmpcPackedLayout = FmpcLayout<NX, NU, NG, true, 1>;

// K8's stage layout: the 13 fields, each offset a multiple of
// stage_align<T, G> values (row_group.cuh; (4, 1, 4) fp32 at G = 4: 82
// values padded to 88), so that a field's region of a chunk of the
// block's L lanes starts on a 128-byte boundary (a TMA box lands only
// there; L is a multiple of a warp's W = 32 / G lanes).
template <typename T, int NX, int NU, int NG, int G>
using FmpcStreamLayout = FmpcLayout<NX, NU, NG, false, stage_align<T, G>()>;

// K8's ring: kFmpcRing buffers of C stages, each filled by one TMA box per
// field of C stages (double-buffered by chunk); C as many stages as the
// two buffers of a 32-lane block fit in kStageBudget, at most
// kMaxStreamChunk: (4, 1, 4) at G = 4 fp32 4, fp64 2; (2, 1, 3) at G =
// 2 fp32 8, fp64 5; (8, 4, 16) fp64 1.
constexpr int kFmpcRing = 2;
constexpr int kMaxStreamChunk = 8;
template <typename T>
__host__ __device__ constexpr int fmpc_stream_chunk(int F) {
  return stages_within<T>(kFmpcRing, F, kMaxStreamChunk);
}

// K9: one buffer of K8's stage layout holding the block's whole horizon
// (a chunk of N stages), for N <= kResidentMaxN (the TPU kernel's unroll
// bound, _RESIDENT_MAX_N; a TMA box spans at most 256 stages).  Its lanes
// per block: row_lanes, halved while the buffer passes kMaxBlockSmem, down
// to a warp's lanes and 4; a shape fits where the fewest lanes' buffer
// does (oscillator (2, 1, 3) and cart-pole (4, 1, 4) at every N <= 32 at
// both dtypes; (8, 4, 16) fp64 up to N = 7).
constexpr int kResidentMaxN = 32;
template <typename T, int G>
__host__ __device__ inline int fmpc_resident_lanes(int F, int N, int B) {
  const int least = (32 / G) > 4 ? 32 / G : 4;
  int L = row_lanes<G>(B);
  while (L > least && ring_bytes<T>(1, N, F, L) > kMaxBlockSmem) L /= 2;
  return L;
}
template <typename T, int G>
__host__ __device__ constexpr bool fmpc_resident_fits(int F, int N) {
  return N >= 1 && N <= kResidentMaxN &&
         ring_bytes<T>(1, N, F, (32 / G) > 4 ? 32 / G : 4) <= kMaxBlockSmem;
}

// K8's lanes per block: row_lanes, halved while the block's ring passes
// kMaxBlockSmem, down to a warp's lanes and 4 (a box row of 16 bytes).
// The cart-pole and the oscillator keep row_lanes; (8, 4, 16) at fp64
// (F = 468 at G = 4, chunks of one stage) takes 16 lanes at B = 4096.
template <typename T, int G>
__host__ __device__ inline int fmpc_stream_lanes(int F, int B) {
  const int C = fmpc_stream_chunk<T>(F);
  const int least = (32 / G) > 4 ? 32 / G : 4;
  int L = row_lanes<G>(B);
  while (L > least && ring_bytes<T>(kFmpcRing, C, F, L) > kMaxBlockSmem)
    L /= 2;
  return L;
}

// A stage's fields as fmpc_stage_group and fmpc_condense_group read them:
// value e of each field, of one lane (K8's scalings: CondensedStageFields).
//   * K10's packed stage (PackedStageFields): value e of a field at p[(off
//     + e) stride], p the lane's column of the stage, stride the buffer's
//     lanes;
//   * K8's chunk (ChunkStageFields): each field's CH stages together, as
//     a TMA box [lanes, size, CH stages] lands them, field X's region at
//     Layout::X CH rows of `stride` lanes, so stage s's value e of X at
//     (Layout::X CH + s size_X + e) stride; K9's whole horizon the same
//     with CH = 0, the chunk's stages n known at run time.
template <typename T, int NX, int NU, int NG>
struct PackedStageFields {
  using O = FmpcPackedLayout<NX, NU, NG>;
  const T* __restrict__ p;
  int stride;
  __device__ T at(int off, int e) const { return p[(off + e) * stride]; }
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
  __device__ T nu_s(int e) const { return at(O::nu_s, e); }
  __device__ T tilde(int e) const { return at(O::tilde, e); }
};

template <typename T, int NX, int NU, int NG, typename Layout, int CH>
struct ChunkStageFields {
  using O = Layout;
  const T* __restrict__ p;
  int s, stride, n;
  __device__ T at(int off, int size, int e) const {
    return p[(off * (CH > 0 ? CH : n) + s * size + e) * stride];
  }
  __device__ T A(int e) const { return at(O::A, NX * NX, e); }
  __device__ T Bm(int e) const { return at(O::Bm, NX * NU, e); }
  __device__ T C(int e) const { return at(O::C, NG * NX, e); }
  __device__ T D(int e) const { return at(O::D, NG * NU, e); }
  __device__ T Lxx(int e) const { return at(O::Lxx, NX * NX, e); }
  __device__ T Luu(int e) const { return at(O::Luu, NU * NU, e); }
  __device__ T Lxu(int e) const { return at(O::Lxu, NX * NU, e); }
  __device__ T xb(int e) const { return at(O::xb, NX, e); }
  __device__ T Lxb(int e) const { return at(O::Lxb, NX, e); }
  __device__ T Lub(int e) const { return at(O::Lub, NU, e); }
  __device__ T ss(int e) const { return at(O::ss, NG, e); }
  __device__ T nu(int e) const { return at(O::nu, NG, e); }
  __device__ T gbar(int e) const { return at(O::gbar, NG, e); }
};

// K8's stage as fmpc_stage_group reads it: the chunk's fields, and the
// condensation scalings the group formed (fmpc_stage.cuh::
// fmpc_condense_group) in registers.
template <typename T, int NG, typename Fields>
struct CondensedStageFields : Fields {
  T scale[NG], shift[NG];   // nu_s, tilde
  __device__ T nu_s(int g) const { return scale[g]; }
  __device__ T tilde(int g) const { return shift[g]; }
};

// K10's chunk: C stages of the packed [N, Fin, B] buffer of a warp's W
// lanes by one TMA box, as K3's (row_group.cuh::packed_chunk_stages), in
// a ring of kPackedRing buffers.  A box takes at most 256 values of a
// stage: past that (Fin = 452 at (8, 4, 16)) the chunk is one stage,
// fetched as `pieces` boxes of `box` values, each buffer holding
// pieces * box values (the last box zero-filled past Fin).
__host__ __device__ constexpr int fmpc_box_values(int Fin) {
  return Fin < 256 ? Fin : 256;
}
__host__ __device__ constexpr int fmpc_box_pieces(int Fin) {
  return (Fin + 255) / 256;
}
__host__ __device__ constexpr int fmpc_slot_values(int Fin) {
  return fmpc_box_pieces(Fin) * fmpc_box_values(Fin);
}
template <typename T>
__host__ __device__ constexpr int fmpc_packed_chunk_stages(int Fin, int N) {
  return Fin > 256 ? 1 : packed_chunk_stages<T>(Fin, N);
}

// K10's lanes per block: row_lanes, halved while the warps' rings pass
// kMaxBlockSmem, down to one warp (the cart-pole and the oscillator keep
// row_lanes; (8, 4, 16) at fp64, 128 KB a warp at G = 4, one warp).
template <typename T, int G>
__host__ __device__ inline int fmpc_packed_lanes(int Fin, int C, int B) {
  constexpr int W = 32 / G;
  int L = row_lanes<G>(B);
  while (L > W && static_cast<size_t>(L / W) *
                          ring_bytes<T>(kPackedRing, C, fmpc_slot_values(Fin),
                                        W) >
                      kMaxBlockSmem)
    L /= 2;
  return L;
}


// K8's and K9's stage fields, one tensor map each (fmpc_backward.cuh).
constexpr int kFmpcFields = 13;

// The wide shapes: past (8, 4, 16) a narrow unit unrolls every field of a
// stage into each thread's registers (fmpc_stage_group) and would spill,
// as K1's did at (9, 16), so K8, K9 and K10 run fmpc_stage_wide.cuh's
// stage there, on kFmpcWideGroup threads a lane, up to (16, 16, 64)
// (kernels/fmpc_backward.py::MAX_NX, MAX_NU, MAX_NG).
__host__ __device__ constexpr bool fmpc_wide(int nx, int nu, int ng) {
  return nx > 8 || nu > 4 || ng > 16;
}
template <int NX, int NU, int NG>
constexpr bool kFmpcWide = fmpc_wide(NX, NU, NG);
// K9's and K10's threads a lane at the wide shapes, and their blocks'
// most threads, the producer warp's included: 8 warps, so that ptxas
// keeps 255 registers a thread (ddp_backward_wide.cuh)
constexpr int kFmpcWideGroup = 32;
constexpr int kFmpcWideMaxThreads = 256;
// K8's block at the wide shapes: box rows of kFmpcWideRowBytes (a
// stage's value e of the block's lanes is a row, so a warp's reads of the
// stage's values fall on fewer banks the wider the row: at the masses
// 64-byte rows ran the stage's sums at ~5x the cycles of 16-byte ones),
// 2 consumer warps and the producer's, so that four blocks share an SM
// (ptxas: 168 registers a thread at the masses), and a ring of two
// one-stage buffers: the producer warp issues a stage's boxes in a
// fraction of the stage's time, so the next stage is enough (PERF.md,
// section 6: 16-byte rows 0.76 ms against 0.94 for 32-byte, 1.34 for
// 64-byte at B = 4096, N = 30, fp32, on an H100).
constexpr int kFmpcWideRowBytes = 16;
constexpr int kFmpcWideStreamThreads = 96;
constexpr int kFmpcWideRing = 2;

// The 13 fields of K8's and K9's stage, in the order of their tensor maps
// (A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, s, nu, g_bar): the
// values of field f.
__host__ __device__ constexpr int fmpc_field_size(int nx, int nu, int ng,
                                                  int f) {
  return f == 0 || f == 4 ? nx * nx
         : f == 1 || f == 6 ? nx * nu
         : f == 2 ? ng * nx
         : f == 3 ? ng * nu
         : f == 5 ? nu * nu
         : f == 7 || f == 8 ? nx
         : f == 9 ? nu
                  : ng;
}

// A wide stage's field arrives in `pieces` TMA boxes of `box` values (a
// box spans at most 256 values along a dimension: C at (12, 3, 30) is 360
// values, two boxes of 184), box a multiple of 8 values, so that every
// piece lands 128-byte aligned at any lane count a wide block takes (a
// lane's row is at least 16 bytes); the last piece is zero-filled past
// the field.  A field's region of a stage is pieces * box values, the
// regions follow one another in the order above (FmpcWideLayout), and
// value e of a field sits at its offset + e.
__host__ __device__ constexpr int fmpc_wide_pieces(int size) {
  return (size + 255) / 256;
}
__host__ __device__ constexpr int fmpc_wide_box(int size) {
  return round_up((size + fmpc_wide_pieces(size) - 1) /
                      fmpc_wide_pieces(size),
                  8);
}
__host__ __device__ constexpr int fmpc_wide_offset(int nx, int nu, int ng,
                                                   int f) {
  int off = 0;
  for (int g = 0; g < f; ++g) {
    const int size = fmpc_field_size(nx, nu, ng, g);
    off += fmpc_wide_pieces(size) * fmpc_wide_box(size);
  }
  return off;
}
__host__ __device__ constexpr int fmpc_wide_boxes(int nx, int nu, int ng) {
  int n = 0;
  for (int f = 0; f < kFmpcFields; ++f)
    n += fmpc_wide_pieces(fmpc_field_size(nx, nu, ng, f));
  return n;
}

// K8's and K9's wide stage: each field's offset, F the stage's values (984
// at the masses' (12, 3, 30): 936 values and the padding of the boxes).
template <int NX, int NU, int NG>
struct FmpcWideLayout {
  static constexpr int A = fmpc_wide_offset(NX, NU, NG, 0),
                       Bm = fmpc_wide_offset(NX, NU, NG, 1),
                       C = fmpc_wide_offset(NX, NU, NG, 2),
                       D = fmpc_wide_offset(NX, NU, NG, 3),
                       Lxx = fmpc_wide_offset(NX, NU, NG, 4),
                       Luu = fmpc_wide_offset(NX, NU, NG, 5),
                       Lxu = fmpc_wide_offset(NX, NU, NG, 6),
                       xb = fmpc_wide_offset(NX, NU, NG, 7),
                       Lxb = fmpc_wide_offset(NX, NU, NG, 8),
                       Lub = fmpc_wide_offset(NX, NU, NG, 9),
                       ss = fmpc_wide_offset(NX, NU, NG, 10),
                       nu = fmpc_wide_offset(NX, NU, NG, 11),
                       gbar = fmpc_wide_offset(NX, NU, NG, 12),
                       F = fmpc_wide_offset(NX, NU, NG, kFmpcFields);
  static constexpr int boxes = fmpc_wide_boxes(NX, NU, NG);
};

// A lane's scratch of the wide stage in shared memory, offsets in values:
// the carry s and P, what the lane's threads exchange within a stage, and
// the Gauss-Jordan fallback's two matrices.  The right-hand sides R and
// the solutions X are [NU][XS]: column 0 is rhs_k / k, column 1 + a is
// row a of H / column a of K (K[m][a] at X[m XS + 1 + a]); G is [NU][US];
// L by columns (Lt[k NU + i] = L[i][k]).  XS and US are odd, so that the
// owners of consecutive rows write to distinct banks.  P - K^T (G K)
// reuses P A's place.
template <int NX, int NU, int NG>
struct WideFmpcScratch {
  static constexpr int XS = (NX + 1) | 1;
  static constexpr int US = NU | 1;
  static constexpr int s = 0;                    // carry s [NX]
  static constexpr int P = s + NX;               // carry P [NX][NX]
  static constexpr int sn = P + NX * NX;         // the new s [NX]
  static constexpr int ns = sn + NX;             // nu / s [NG]
  static constexpr int tl = ns + NG;             // tilde [NG]
  static constexpr int PA = tl + NG;             // P A, then Pn [NX][NX]
  static constexpr int PB = PA + NX * NX;        // P B [NX][NU]
  static constexpr int Pxb = PB + NX * NU;       // P x_bar [NX]
  static constexpr int F = Pxb + NX;             // [NX][NX]
  static constexpr int Gm = F + NX * NX;         // G [NU][US]
  static constexpr int Lxt = Gm + NU * US;       // Lx_t [NX]
  static constexpr int R = Lxt + NX;             // [NU][XS]
  static constexpr int X = R + NU * XS;          // [NU][XS]
  static constexpr int Lt = X + NU * XS;         // [NU][NU]
  static constexpr int Fd = Lt + NU * NU;        // G's diagonal [NU]
  static constexpr int GK = Fd + NU;             // G K [NU][NX]
  static constexpr int Ga = GK + NU * NX;        // Gauss-Jordan: G [NU][NU]
  static constexpr int Gi = Ga + NU * NU;        // and its inverse
  static constexpr int size = Gi + NU * NU;
};

// The values of a lane's WideFmpcScratch, at run time.
__host__ __device__ constexpr int fmpc_wide_scratch(int nx, int nu,
                                                    int ng) {
  const int xs = (nx + 1) | 1, us = nu | 1;
  return 4 * nx + 3 * nx * nx + 2 * ng + 2 * nx * nu + nu * us +
         2 * nu * xs + 3 * nu * nu + nu;
}
static_assert(WideFmpcScratch<12, 3, 30>::size ==
                      fmpc_wide_scratch(12, 3, 30) &&
                  WideFmpcScratch<16, 16, 64>::size ==
                      fmpc_wide_scratch(16, 16, 64),
              "the scratch's size at run time is its layout's");

// The size rules of a wide block of L lanes of G threads at (nx, nu, ng)
// and T, at run time (fmpc_wide_rule), so that one loop can hold them at
// every shape up to the ceiling; WideFmpcBlock and WideFmpcPackedBlock
// are a unit's.  Every block's lanes are at least `least`: a warp's lanes
// and a box row of 16 bytes (4 at G = 16 or 32 fp32, 2 at fp64).
//   * K8 (at kFmpcWideStreamGroup): a ring of R one-stage buffers of F
//     values a lane (a multiple of 128 bytes: F is a multiple of 8
//     values, a lane's row at least 16 bytes) after 128 bytes of
//     barriers, then each lane's scratch, `stride` values apart (the
//     scratch rounded up to 128 bytes); least lanes at every B
//     (max_lanes: one kFmpcWideRowBytes row, the 2 consumer warps of
//     kFmpcWideStreamThreads), R kFmpcWideRing buffers, fewer where they
//     do not fit (ring; the masses' (12, 3, 30): 4 lanes of 16 threads
//     at fp32, 2 of 32 at fp64, 43,392 bytes).
//   * K9 (at kFmpcWideGroup): the horizon's N one-stage buffers after N
//     barriers (rounded up to 128 bytes), then the scratch; it takes N <=
//     kResidentMaxN where those and the fewest lanes' scratch fit
//     (resident_fits: the masses up to N = 14 at both dtypes), at
//     resident_max_lanes (kMaxRowLanes, halved while the block passes
//     kFmpcWideMaxThreads or one stage's buffer does not fit), halved
//     while the batch fills fewer than kFillBlocks blocks (fill) or the
//     horizon does not fit (resident_lanes: the masses' N = 12, 4 lanes
//     at fp32, 2 at fp64).
//   * K10 (packed_*, at kFmpcWideGroup): two buffers of C stages of the
//     packed [N, Fin, B] buffer seen as N Fin rows, each rounded up to
//     whole boxes of kWideBoxRows rows (row_group.cuh::wide_chunk_rows: a
//     box spans at most 256 values, Fin = 906 at the masses), then the
//     scratch; packed_max_lanes as K9's, one chunk's buffers in place of
//     its stage; C the most stages, at most kMaxChunk, that keep a block
//     of packed_max_lanes within a block's shared memory (the masses: 7
//     at fp32, 3 at fp64).
template <typename T>
struct FmpcWideRule {
  int G, F, Fin, stride, least;

  __host__ __device__ constexpr size_t scratch_bytes(int L) const {
    return static_cast<size_t>(L) * stride * sizeof(T);
  }
  __host__ __device__ constexpr size_t buffer_bytes(int L) const {
    return static_cast<size_t>(F) * L * sizeof(T);
  }
  __host__ __device__ constexpr size_t bytes(int R, int L) const {
    return 128 + R * buffer_bytes(L) + scratch_bytes(L);
  }
  __host__ __device__ constexpr size_t resident_bytes(int N, int L) const {
    return static_cast<size_t>(round_up(8 * N, 128)) + N * buffer_bytes(L) +
           scratch_bytes(L);
  }
  __host__ __device__ constexpr int max_lanes() const { return least; }
  __host__ __device__ constexpr int ring() const {
    int R = kFmpcWideRing;
    while (R > 1 && bytes(R, least) > kMaxBlockSmem) --R;
    return R;
  }
  __host__ __device__ constexpr bool fits() const {
    return bytes(1, least) <= kMaxBlockSmem;
  }
  __host__ __device__ constexpr int fill(int most, int B) const {
    int L = most;
    while (L > least && (B + L - 1) / L < kFillBlocks) L /= 2;
    return L;
  }
  __host__ __device__ constexpr bool resident_fits(int N) const {
    return N >= 1 && N <= kResidentMaxN &&
           resident_bytes(N, least) <= kMaxBlockSmem;
  }
  __host__ __device__ constexpr int resident_max_lanes() const {
    int L = kMaxRowLanes;
    while (L > least && (L * G + 32 > kFmpcWideMaxThreads ||
                         resident_bytes(1, L) > kMaxBlockSmem))
      L /= 2;
    return L;
  }
  __host__ __device__ constexpr int resident_lanes(int N, int B) const {
    int L = fill(resident_max_lanes(), B);
    while (L > least && resident_bytes(N, L) > kMaxBlockSmem) L /= 2;
    return L;
  }
  __host__ __device__ constexpr size_t packed_bytes(int C, int L) const {
    return wide_chunk_bytes<T>(C, Fin, kWideBoxRows, L,
                               static_cast<size_t>(stride) * sizeof(T));
  }
  __host__ __device__ constexpr int packed_max_lanes() const {
    int L = kMaxRowLanes;
    while (L > least && (L * G + 32 > kFmpcWideMaxThreads ||
                         packed_bytes(1, L) > kMaxBlockSmem))
      L /= 2;
    return L;
  }
  __host__ __device__ constexpr int packed_chunk() const {
    return wide_chunk_stages<T>(Fin, kWideBoxRows, packed_max_lanes(),
                                static_cast<size_t>(stride) * sizeof(T));
  }
  __host__ __device__ constexpr bool packed_fits() const {
    return packed_bytes(1, least) <= kMaxBlockSmem;
  }
  __host__ __device__ constexpr int packed_lanes(int B) const {
    return fill(packed_max_lanes(), B);
  }
};

template <typename T>
__host__ __device__ constexpr FmpcWideRule<T> fmpc_wide_rule(int nx, int nu,
                                                             int ng, int G) {
  const int per = 128 / static_cast<int>(sizeof(T));
  const int item = static_cast<int>(sizeof(T));
  return FmpcWideRule<T>{
      G, fmpc_wide_offset(nx, nu, ng, kFmpcFields),
      fmpc_offsets(nx, nu, ng, true, 1).F,
      round_up(fmpc_wide_scratch(nx, nu, ng), per),
      (32 / G) > 16 / item ? 32 / G : 16 / item};
}

// K8's threads a lane at the wide shapes: the block's 2 consumer warps
// over the lanes of a kFmpcWideRowBytes row (16 at fp32, 32 at fp64).
template <typename T>
constexpr int kFmpcWideStreamGroup =
    (kFmpcWideStreamThreads - 32) /
    (kFmpcWideRowBytes / static_cast<int>(sizeof(T)));

// A unit's K8 / K9 block and its K10 block (fmpc_backward_wide.cuh,
// fmpc_backward_packed_wide.cuh): the rule at its shape, and its sizes.
template <typename T, int NX, int NU, int NG, int G>
struct WideFmpcBlock {
  __host__ __device__ static constexpr FmpcWideRule<T> rule() {
    return fmpc_wide_rule<T>(NX, NU, NG, G);
  }
  static constexpr int F = fmpc_wide_rule<T>(NX, NU, NG, G).F;
  static constexpr int stride = fmpc_wide_rule<T>(NX, NU, NG, G).stride;
  static constexpr int least = fmpc_wide_rule<T>(NX, NU, NG, G).least;
  static constexpr int max_lanes =
      fmpc_wide_rule<T>(NX, NU, NG, G).max_lanes();
  static constexpr int resident_max_lanes =
      fmpc_wide_rule<T>(NX, NU, NG, G).resident_max_lanes();
  static constexpr int ring = fmpc_wide_rule<T>(NX, NU, NG, G).ring();
};
template <typename T, int NX, int NU, int NG, int G>
struct WideFmpcPackedBlock {
  __host__ __device__ static constexpr FmpcWideRule<T> rule() {
    return fmpc_wide_rule<T>(NX, NU, NG, G);
  }
  static constexpr int Fin = fmpc_wide_rule<T>(NX, NU, NG, G).Fin;
  static constexpr int stride = fmpc_wide_rule<T>(NX, NU, NG, G).stride;
  static constexpr int least = fmpc_wide_rule<T>(NX, NU, NG, G).least;
  static constexpr int max_lanes =
      fmpc_wide_rule<T>(NX, NU, NG, G).packed_max_lanes();
  static constexpr int chunk =
      fmpc_wide_rule<T>(NX, NU, NG, G).packed_chunk();
};

}  // namespace nmpc

// FMPC forward Δx/Δu recursion for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_forward_pallas.py::
// _forward_fmpc_call (kernel _make_kernel; entry
// forward_fmpc_deltas_pallas).  Its plain version is
// nmpc_tpu_torch/kernels/fmpc_forward.py::forward_fmpc_deltas_plain:
//   du_i = K_i dx_i + k_i,  dx_{i+1} = A_i dx_i + B_i du_i + x_bar_i,
// dxs[i] the delta before stage i, dxs[N] the final carry.  Each mat-vec
// sums in index order; A dx and B du are summed apart and then added, as
// the plain version's two torch.sum calls are.
//
// What bounds it on the card: bytes, once they reach the SMs in time.
// Per stage and lane it reads A, B, x_bar, k, K (29 values at the
// cart-pole's (nx, nu) = (4, 1)) and writes dx, du (5): 55.8 MB at B =
// 4096, N = 100, 16.7 us at 3.35 TB/s; the arithmetic is ~60 flops, a
// chain of tens of ns a stage.  One thread per lane loading stage i+1's
// coefficients into registers before stage i (the TPU kernel's
// double-buffered stage DMA) kept ~3.7 KB in flight per SM at one warp an
// SM, and each stage waited on a memory round trip (0.78 us a stage;
// PERF.md, Findings).
//
// What the design does about it:
//   * the coefficients of the next (R - 1) C to R C stages are in flight
//     in shared memory while the chain runs (fwd_ring.cuh: a ring of R
//     chunks of C stages, filled by a producer warp's TMA boxes, one per
//     field and chunk; a field TMA does not take as it is the wrapper
//     copies once, kernels/fmpc_forward.py);
//   * a lane is a group of G threads (kFmpcFwdGroup): thread r owns rows
//     r, r + G, ... of A dx + B du + x_bar, every thread computes du = K
//     dx + k (past (8, 4) each its rows of it too, exchanged), and the
//     rows of dx reach the group by shuffles.  Every value
//     is computed by one thread in the one-thread order, so every (C, G)
//     gives the same bits (built with -fmad=false);
//   * dx and du are stored batch-minor, each row by the thread that owns
//     it (du's rows split r mod G), coalesced across a warp's lanes.
// The Δλ/Δs/Δν post-passes stay torch ops, as they stay XLA in JAX.
// Templated on the scalar type, (NX, NU), G and C; the wrapper
// (kernels/fmpc_forward.py) instantiates it per (nx, nu, dtype).

#pragma once

#include "fwd_ring.cuh"

namespace nmpc {

// A stage's fields: A [NX][NX], B [NX][NU], x_bar [NX], k [NU], K [NU][NX].
template <int NX, int NU>
using FmpcFwdFields = FwdFields<NX * NX, NX * NU, NX, NU, NU * NX>;

// Threads per lane and chunk of stages, chosen by measurement on the H100 among G = 1, 2, 4 and C = 1, 2, 4, 8 at (4, 1),
// (2, 1) and (2, 2) (chip_smoke.py --qp-groups; PERF.md, Findings): 2
// threads per lane at nu = 1 but fp64 at nx >= 4, else one (every thread
// of a group forms all of du); chunks of 4 stages at nx >= 4 (fp64: 2)
// and of 8 below.  Past (8, 4) (kFmpcFwdWide: the masses' (12, 3) up to
// (16, 16)) a group of 4 splits the rows of both products, du's too: a
// stage's 800 values of 32 lanes (one thread a lane) at fp64 pass a
// block's shared memory twice over, and a group of 4 keeps the ring of
// two one-stage buffers of the fewest lanes (8) within it.
template <int NX, int NU>
constexpr bool kFmpcFwdWide = NX > 8 || NU > 4;
template <typename T, int NX, int NU>
constexpr int kFmpcFwdGroup =
    kFmpcFwdWide<NX, NU> ? 4
                         : (NU == 1 && !(sizeof(T) == 8 && NX >= 4) ? 2 : 1);
template <typename T, int NX, int NU>
constexpr int fmpc_fwd_chunk() {
  return fwd_chunk<T>(FmpcFwdFields<NX, NU>::F,
                      NX < 4 ? 8 : (sizeof(T) == 8 ? 2 : 4));
}

// The recursion of one lane's group: `feed` the block's (fwd_block).
template <typename T, int NX, int NU, int G, int C, typename Feed>
__device__ __forceinline__ void fmpc_forward_group(
    Feed& feed, const FwdLayout<T, FmpcFwdFields<NX, NU>>& l,
    const GroupLane<G>& at, const T* __restrict__ dx0, T* __restrict__ dxs,
    T* __restrict__ dus, int N, int B) {
  using Fs = FmpcFwdFields<NX, NU>;
  enum { kA, kB, kXb, kK, kKK };
  constexpr int J = (NX + G - 1) / G;
  const int r = LaneGroup<G>::rank();
  const int b = at.b;
  T dx[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) dx[a] = dx0[static_cast<size_t>(a) * B + b];
  auto stage = [&](const FwdView<T, Fs>& v, int s, int i) {
    T du[NU];
    if constexpr (kFmpcFwdWide<NX, NU> && G > 1) {
      // rows a = r, r + G, ... of du by this thread, then exchanged
      constexpr int JU = (NU + G - 1) / G;
      T duo[JU];
#pragma unroll
      for (int j = 0; j < JU; ++j) {
        const int a = j * G + r < NU ? j * G + r : NU - 1;
        T sum = v(kKK, s, a * NX) * dx[0];
#pragma unroll
        for (int c = 1; c < NX; ++c)
          sum = sum + v(kKK, s, a * NX + c) * dx[c];
        duo[j] = sum + v(kK, s, a);
        if (at.live && j * G + r < NU) dus[idx2(i, a, NU, b, B)] = duo[j];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a)
        du[a] = LaneGroup<G>::bcast(duo[a / G], a % G);
    } else {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T sum = v(kKK, s, a * NX) * dx[0];
#pragma unroll
        for (int c = 1; c < NX; ++c)
          sum = sum + v(kKK, s, a * NX + c) * dx[c];
        du[a] = sum + v(kK, s, a);
        if (at.live && a % G == r) dus[idx2(i, a, NU, b, B)] = du[a];
      }
    }
    T dxn[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int a = j * G + r;
      dxn[j] = T(0);
      if (a >= NX) continue;
      if (at.live) dxs[idx2(i, a, NX, b, B)] = dx[a];
      T sa = v(kA, s, a * NX) * dx[0];
#pragma unroll
      for (int c = 1; c < NX; ++c) sa = sa + v(kA, s, a * NX + c) * dx[c];
      T sb = v(kB, s, a * NU) * du[0];
#pragma unroll
      for (int c = 1; c < NU; ++c) sb = sb + v(kB, s, a * NU + c) * du[c];
      dxn[j] = sa + sb + v(kXb, s, a);
    }
#pragma unroll
    for (int a = 0; a < NX; ++a)
      dx[a] = G == 1 ? dxn[a] : LaneGroup<G>::bcast(dxn[a / G], a % G);
  };
  const int n = fwd_chunks(N, C);
  for (int c = 0; c < n; ++c)
    fwd_chunk_stages<T, Fs, C>(feed, l, c, N, stage);
#pragma unroll
  for (int a = 0; a < NX; ++a)
    if (at.live && a % G == r) dxs[idx2(N, a, NX, b, B)] = dx[a];
}

template <typename T, int NX, int NU, int G, int C>
__global__ void __launch_bounds__(kMaxRowLanes * G + 32)
fmpc_forward_kernel(const __grid_constant__ FwdInputs<T, FmpcFwdFields<NX, NU>>
                        in,
                    const T* __restrict__ dx0, T* __restrict__ dxs,
                    T* __restrict__ dus, int N, int B) {
  using Fs = FmpcFwdFields<NX, NU>;
  fwd_block<T, Fs, G, C>(
      in, N, B, [&](auto& feed, const FwdLayout<T, Fs>& l,
                    const GroupLane<G>& at) {
        fmpc_forward_group<T, NX, NU, G, C>(feed, l, at, dx0, dxs, dus, N,
                                            B);
      });
}

// Launch on `stream`; returns a CUDA error code: of a field's tensor map,
// of the shared-memory attribute, or cudaGetLastError() after the launch.
// A, Bm, xb, ks, Ks batch-minor [N, size, B] with their lanes ld values
// apart (ld * sizeof(T) and each address multiples of 16 bytes); dx0 [NX,
// B], dxs [N + 1, NX, B], dus [N, NU, B] contiguous.  G threads per lane
// and chunks of C stages as kFmpcFwdGroup and fmpc_fwd_chunk say unless a
// measurement asks for others.
template <typename T, int NX, int NU, int G = kFmpcFwdGroup<T, NX, NU>,
          int C = fmpc_fwd_chunk<T, NX, NU>()>
int launch_fmpc_forward(int N, int B, int ld, const void* A, const void* Bm,
                        const void* xb, const void* ks, const void* Ks,
                        const void* dx0, void* dxs, void* dus, void* stream) {
  using Fs = FmpcFwdFields<NX, NU>;
  static_assert(fwd_smem<T, Fs>(C, fwd_least_lanes<G>()) <= kMaxBlockSmem,
                "a block's ring of chunks passes its shared memory");
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int L = fwd_lanes<T, Fs, G>(C, B);
  const void* fields[Fs::NF] = {A, Bm, xb, ks, Ks};
  FwdInputs<T, Fs> in;
  int err = fwd_inputs<T, Fs>(in, fields, N, B, ld, L, C);
  if (err != 0) return err;
  const size_t smem = fwd_smem<T, Fs>(C, L);
  err = allow_dynamic_smem(fmpc_forward_kernel<T, NX, NU, G, C>, smem);
  if (err != 0) return err;
  fmpc_forward_kernel<T, NX, NU, G, C>
      <<<(B + L - 1) / L, L * G + 32, smem,
         static_cast<cudaStream_t>(stream)>>>(
          in, static_cast<const T*>(dx0), static_cast<T*>(dxs),
          static_cast<T*>(dus), N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

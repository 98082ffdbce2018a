// Packed FMPC condensed Riccati backward for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call_packed (kernel _make_kernel_packed): K8's
// recursion (fmpc_backward.cuh) with every stage's 12 input fields read
// from one [N, Fin, B] buffer and the four outputs written to one
// [N, Fout, B] buffer, in the order and at the offsets of _field_offsets:
// inputs A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, nu_s, tilde;
// outputs k, K, s, P; every matrix row-major (Fin = 78, Fout = 25 at the
// cart-pole's (nx, nu, ng) = (4, 1, 4)).  The wrapper (kernels/
// fmpc_backward.py) packs with torch.cat and slices the outputs back; the
// plain version unpacks, runs the torch recursion and packs.  The stage
// is fmpc_stage.cuh::fmpc_stage, unchanged: built without FMA contraction
// as K8 is, the result equals K8's bit for bit.
//
// What bounds it on the card: as K8, the per-lane dependent chain (~600
// flops per stage between a stage's 78 reads and 25 writes), one warp per
// SM at B = 4096; and the pack and unpack around it read and write every
// field once more.
//
// What the design does about it: as K8, one thread per lane with the
// (s, P, ok) carry in registers and, at fp32, the next stage's Fin values
// loaded before this stage is computed; each stage's reads and writes are
// one contiguous [F, B] slab each (the TPU kernel's one DMA per stage and
// direction).  The terminal (s_T, P_T) is not written (the wrapper
// appends it) but enters the finite flag, as in K8.

#pragma once

#include "fmpc_backward.cuh"

namespace nmpc {

// Input offsets of the packed stage (fmpc_backward_pallas.py::
// _field_offsets), and output offsets.
template <int NX, int NU, int NG>
struct FmpcPackedLayout {
  static constexpr int A = 0;
  static constexpr int Bm = A + NX * NX;
  static constexpr int C = Bm + NX * NU;
  static constexpr int D = C + NG * NX;
  static constexpr int Lxx = D + NG * NU;
  static constexpr int Luu = Lxx + NX * NX;
  static constexpr int Lxu = Luu + NU * NU;
  static constexpr int xb = Lxu + NX * NU;
  static constexpr int Lxb = xb + NX;
  static constexpr int Lub = Lxb + NX;
  static constexpr int nu_s = Lub + NU;
  static constexpr int tilde = nu_s + NG;
  static constexpr int Fin = tilde + NG;
  static constexpr int k = 0;
  static constexpr int K = k + NU;
  static constexpr int s = K + NU * NX;
  static constexpr int P = s + NX;
  static constexpr int Fout = P + NX * NX;
};

// One stage of one lane from a packed slab: value e at p[e * stride]
// (device memory: stride B; the resident kernel's shared memory: stride
// the block's lane count).
template <typename T, int NX, int NU, int NG>
__device__ __forceinline__ void load_fmpc_packed(
    const T* __restrict__ p, size_t stride, FmpcStage<T, NX, NU, NG>& s) {
  using O = FmpcPackedLayout<NX, NU, NG>;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.A[a][c] = p[(O::A + a * NX + c) * stride];
      s.Lxx[a][c] = p[(O::Lxx + a * NX + c) * stride];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Bm[a][c] = p[(O::Bm + a * NU + c) * stride];
      s.Lxu[a][c] = p[(O::Lxu + a * NU + c) * stride];
    }
    s.xb[a] = p[(O::xb + a) * stride];
    s.Lxb[a] = p[(O::Lxb + a) * stride];
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int c = 0; c < NX; ++c) s.C[g][c] = p[(O::C + g * NX + c) * stride];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.D[g][c] = p[(O::D + g * NU + c) * stride];
    s.nu_s[g] = p[(O::nu_s + g) * stride];
    s.tilde[g] = p[(O::tilde + g) * stride];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lub[a] = p[(O::Lub + a) * stride];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = p[(O::Luu + a * NU + c) * stride];
  }
}

// The terminal carry (s_T, P_T, ok) of lane b; returns whether it is
// finite.
template <typename T, int NX>
__device__ __forceinline__ bool init_fmpc_carry(const T* __restrict__ sT,
                                                const T* __restrict__ PT,
                                                int b, int B,
                                                FmpcCarry<T, NX>& c) {
  bool fin = true;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.s[a] = sT[static_cast<size_t>(a) * B + b];
    fin = fin && finite(c.s[a]);
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      c.P[a][e] = PT[(static_cast<size_t>(a) * NX + e) * B + b];
      fin = fin && finite(c.P[a][e]);
    }
  }
  c.ok = true;
  return fin;
}

template <typename T, int NX, int NU, int NG, bool PREFETCH>
__global__ void __launch_bounds__(kLaneThreads)
fmpc_backward_packed_kernel(const T* __restrict__ Pin,
                            const T* __restrict__ sT,
                            const T* __restrict__ PT, T* __restrict__ out,
                            unsigned char* __restrict__ ok_out,
                            unsigned char* __restrict__ finite_out, int N,
                            int B, T dt, int break_if_llt_fails,
                            int check_nan) {
  using O = FmpcPackedLayout<NX, NU, NG>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  FmpcCarry<T, NX> c;
  bool fin = init_fmpc_carry<T, NX>(sT, PT, b, B, c);
  const bool brk = break_if_llt_fails != 0;
  const size_t in_stage = static_cast<size_t>(O::Fin) * B;
  const size_t out_stage = static_cast<size_t>(O::Fout) * B;

  FmpcStage<T, NX, NU, NG> cur;
  if (PREFETCH) load_fmpc_packed<T, NX, NU, NG>(Pin + (N - 1) * in_stage + b,
                                                B, cur);
  for (int i = N - 1; i >= 0; --i) {
    FmpcStage<T, NX, NU, NG> nxt;
    if (PREFETCH) {
      if (i > 0)
        load_fmpc_packed<T, NX, NU, NG>(Pin + (i - 1) * in_stage + b, B, nxt);
    } else {
      load_fmpc_packed<T, NX, NU, NG>(Pin + i * in_stage + b, B, cur);
    }
    T k[NU], K[NU][NX];
    fmpc_stage<T, NX, NU, NG>(cur, dt, brk, c, k, K);
    T* o = out + i * out_stage + b;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      o[static_cast<size_t>(O::k + a) * B] = k[a];
      fin = fin && finite(k[a]);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        o[static_cast<size_t>(O::K + a * NX + e) * B] = K[a][e];
        fin = fin && finite(K[a][e]);
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      o[static_cast<size_t>(O::s + a) * B] = c.s[a];
      fin = fin && finite(c.s[a]);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        o[static_cast<size_t>(O::P + a * NX + e) * B] = c.P[a][e];
        fin = fin && finite(c.P[a][e]);
      }
    }
    if (PREFETCH) cur = nxt;
  }
  ok_out[b] = c.ok ? 1 : 0;
  finite_out[b] = (fin || !check_nan) ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() after the launch.  Pin
// [N, Fin, B] and out [N, Fout, B] are contiguous device arrays, sT
// [NX, B], PT [NX, NX, B]; ok and finite are one byte per lane.
template <typename T, int NX, int NU, int NG, bool PREFETCH>
int launch_fmpc_backward_packed(int N, int B, double dt,
                                int break_if_llt_fails, int check_nan,
                                const void* Pin, const void* sT,
                                const void* PT, void* out, void* ok,
                                void* finite, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  fmpc_backward_packed_kernel<T, NX, NU, NG, PREFETCH>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(Pin), static_cast<const T*>(sT),
          static_cast<const T*>(PT), static_cast<T*>(out),
          static_cast<unsigned char*>(ok),
          static_cast<unsigned char*>(finite), N, B, static_cast<T>(dt),
          break_if_llt_fails, check_nan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

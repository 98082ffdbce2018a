// FMPC condensed primal-dual Riccati backward for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call (kernel _make_kernel, stage _fmpc_stage,
// inverse _inv_t; entry backward_fmpc_pallas).  Its plain version is
// nmpc_tpu_torch/solvers/fmpc.py::_backward_bm; the stage is
// fmpc_stage.cuh::fmpc_stage.
//
// The condensation scalings nu/s and tilde are computed by the wrapper
// (kernels/fmpc_backward.py::condensation, which the plain version shares),
// as the JAX wrapper precomputes them (fmpc_backward_pallas.py:699-703),
// so the kernel streams 12 per-stage fields and takes no barrier input.
// It writes the terminal (s_T, P_T) as row N of svecs and Ps, and the
// per-lane finite flag over every value it writes (the plain version's
// check_nan test), so the wrapper runs no reduction.
//
// What bounds it on the card: the per-lane dependent chain, not bytes.
// Per stage and lane it reads the 12 fields (78 values at the cart-pole's
// (nx, nu, ng) = (4, 1, 4)) and writes k, K, s and P (25 values); between
// them the thread runs ~600 dependent flops (the condensation, three
// matrix products with P, a Cholesky of G).  One thread per lane at
// B = 4096 is 128 warps on 132 SMs: one warp per SM, so the load and
// arithmetic latencies of the N-stage chain are not hidden.
//
// What the design does about it, as K1 (ddp_backward.cu):
//   * one thread per lane walks i = N-1 ... 0 with the (s, P, ok) carry in
//     registers;
//   * with PREFETCH, stage i-1's fields are loaded before stage i is
//     computed (the TPU kernel's double-buffered stage DMA); the fp64
//     units are built without it, whose second stage of fields would not
//     fit the register file;
//   * the Gauss-Jordan fallback runs only on lanes whose LLT failed.
// Templated on the scalar type, (NX, NU, NG) and PREFETCH; the wrapper
// instantiates it per (nx, nu, ng, dtype) in a small generated unit.

#pragma once

#include "fmpc_stage.cuh"
#include "remat_common.cuh"

namespace nmpc {

template <typename T>
struct FmpcFields {
  const T* __restrict__ A;
  const T* __restrict__ Bm;
  const T* __restrict__ C;
  const T* __restrict__ D;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
  const T* __restrict__ xb;
  const T* __restrict__ Lxb;
  const T* __restrict__ Lub;
  const T* __restrict__ nu_s;
  const T* __restrict__ tilde;
};

template <typename T, int NX, int NU, int NG>
__device__ __forceinline__ void load_fmpc_stage(const FmpcFields<T>& f, int i,
                                                int b, int B,
                                                FmpcStage<T, NX, NU, NG>& s) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.A[a][c] = f.A[idx3(i, a, c, NX, NX, b, B)];
      s.Lxx[a][c] = f.Lxx[idx3(i, a, c, NX, NX, b, B)];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Bm[a][c] = f.Bm[idx3(i, a, c, NX, NU, b, B)];
      s.Lxu[a][c] = f.Lxu[idx3(i, a, c, NX, NU, b, B)];
    }
    s.xb[a] = f.xb[idx2(i, a, NX, b, B)];
    s.Lxb[a] = f.Lxb[idx2(i, a, NX, b, B)];
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int c = 0; c < NX; ++c) s.C[g][c] = f.C[idx3(i, g, c, NG, NX, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.D[g][c] = f.D[idx3(i, g, c, NG, NU, b, B)];
    s.nu_s[g] = f.nu_s[idx2(i, g, NG, b, B)];
    s.tilde[g] = f.tilde[idx2(i, g, NG, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lub[a] = f.Lub[idx2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f.Luu[idx3(i, a, c, NU, NU, b, B)];
  }
}

// Row i of svecs [N+1, NX, B] and Ps [N+1, NX, NX, B] from the carry;
// returns whether every value is finite.
template <typename T, int NX>
__device__ __forceinline__ bool store_carry(const FmpcCarry<T, NX>& c, int i,
                                            int b, int B, T* __restrict__ sv,
                                            T* __restrict__ Ps) {
  bool fin = true;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    sv[idx2(i, a, NX, b, B)] = c.s[a];
    fin = fin && finite(c.s[a]);
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      Ps[idx3(i, a, e, NX, NX, b, B)] = c.P[a][e];
      fin = fin && finite(c.P[a][e]);
    }
  }
  return fin;
}

template <typename T, int NX, int NU, int NG, bool PREFETCH>
__global__ void __launch_bounds__(kLaneThreads)
fmpc_backward_kernel(FmpcFields<T> f, const T* __restrict__ sT,
                     const T* __restrict__ PT, T* __restrict__ ks,
                     T* __restrict__ Ks, T* __restrict__ sv,
                     T* __restrict__ Ps, unsigned char* __restrict__ ok_out,
                     unsigned char* __restrict__ finite_out, int N, int B,
                     T dt, int break_if_llt_fails, int check_nan) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  FmpcCarry<T, NX> c;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.s[a] = sT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      c.P[a][e] = PT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  c.ok = true;
  bool fin = store_carry<T, NX>(c, N, b, B, sv, Ps);
  const bool brk = break_if_llt_fails != 0;

  FmpcStage<T, NX, NU, NG> cur;
  if (PREFETCH) load_fmpc_stage<T, NX, NU, NG>(f, N - 1, b, B, cur);
  for (int i = N - 1; i >= 0; --i) {
    FmpcStage<T, NX, NU, NG> nxt;
    if (PREFETCH) {
      if (i > 0) load_fmpc_stage<T, NX, NU, NG>(f, i - 1, b, B, nxt);
    } else {
      load_fmpc_stage<T, NX, NU, NG>(f, i, b, B, cur);
    }
    T k[NU], K[NU][NX];
    fmpc_stage<T, NX, NU, NG>(cur, dt, brk, c, k, K);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      ks[idx2(i, a, NU, b, B)] = k[a];
      fin = fin && finite(k[a]);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
        fin = fin && finite(K[a][e]);
      }
    }
    fin = store_carry<T, NX>(c, i, b, B, sv, Ps) && fin;
    if (PREFETCH) cur = nxt;
  }
  ok_out[b] = c.ok ? 1 : 0;
  finite_out[b] = (fin || !check_nan) ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() after the launch.  All
// arrays are contiguous batch-minor device arrays; ok and finite are one
// byte per lane.  fields: A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar,
// Lu_bar, nu_s, tilde.
template <typename T, int NX, int NU, int NG, bool PREFETCH>
int launch_fmpc_backward(int N, int B, double dt, int break_if_llt_fails,
                         int check_nan, const void* const* fields,
                         const void* sT, const void* PT, void* ks, void* Ks,
                         void* sv, void* Ps, void* ok, void* finite,
                         void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const FmpcFields<T> f{at(0), at(1), at(2), at(3), at(4),  at(5),
                        at(6), at(7), at(8), at(9), at(10), at(11)};
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  fmpc_backward_kernel<T, NX, NU, NG, PREFETCH>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(sT), static_cast<const T*>(PT),
          static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(sv),
          static_cast<T*>(Ps), static_cast<unsigned char*>(ok),
          static_cast<unsigned char*>(finite), N, B, static_cast<T>(dt),
          break_if_llt_fails, check_nan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

// Resident FMPC condensed Riccati backward for Hopper (sm_90a): the whole
// horizon of a block's lanes in shared memory.
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call_resident (kernel _make_kernel_resident):
// K8's recursion (fmpc_backward.cuh) for short horizons, N <= 32
// (_RESIDENT_MAX_N), with K8's outputs; it takes the condensation
// scalings nu_s and tilde from the wrapper (kernels/fmpc_backward.py::
// condensation).  The stage is fmpc_stage.cuh::fmpc_stage, one thread per
// lane: built without FMA contraction as K8 is, the result equals K8's bit
// for bit.
//
// What bounds it on the card: the per-lane dependent chain of N stages
// (~600 flops each at the cart-pole's (4, 1, 4)) and, at a short horizon,
// the latency of the first loads: a kernel that streams the stages waits
// on each stage's fields before it can start that stage.
//
// What the design does about it: a block of L = 32 lanes (one thread per
// lane, so that B = 4096 still spreads over 128 SMs) first issues every
// copy of its lanes' whole horizon into dynamic shared memory with
// cp.async, laid out [stage][field element][lane] in the packed order of
// fmpc_group.cuh::FmpcPackedLayout (a warp's copies of one element are 32
// neighbouring lanes: one coalesced request; its reads hit 32 neighbouring
// words: no bank conflict), so all N * Fin loads of a lane are in flight
// together instead of one stage's at a time.  It writes the terminal row
// while they land, then runs the recursion from shared memory.  Outputs go
// straight to device memory, as K8's do.  The footprint is N * Fin * 32
// scalars per block (oscillator (2, 1, 3) at N = 20, fp32: 84 KB; the
// cart-pole fits up to N = 23 at fp32, 11 at fp64), so the launch raises
// the kernel's shared-memory limit above 48 KB (H100: 227 KB per block);
// kernels/fmpc_backward.py::resident_fits says which shapes fit.  Each
// thread copies and reads only its own column: no block barrier.

#pragma once

#include "cp_async.cuh"
#include "fmpc_group.cuh"
#include "fmpc_stage.cuh"
#include "remat_common.cuh"

namespace nmpc {

// The stage fields of the resident kernel, each a batch-minor device
// array.
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

// One stage of one lane from a packed slab: value e at p[e * stride]
// (shared memory: stride the block's lane count).
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

// The terminal carry (s_T, P_T, ok) of lane b.
template <typename T, int NX>
__device__ __forceinline__ void init_fmpc_carry(const T* __restrict__ sT,
                                                const T* __restrict__ PT,
                                                int b, int B,
                                                FmpcCarry<T, NX>& c) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.s[a] = sT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      c.P[a][e] = PT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  c.ok = true;
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

// Copy field `src` ([N, SIZE, B]) of every stage of lane b into the slab:
// element j of stage i at slab[(i Fin + off + j) L].
template <typename T, int SIZE>
__device__ __forceinline__ void stage_fmpc_field(const T* __restrict__ src,
                                                 int off, int Fin, int N,
                                                 int b, int B, T* slab,
                                                 int L) {
  for (int i = 0; i < N; ++i) {
    const T* row = src + static_cast<size_t>(i) * SIZE * B + b;
    T* dst = slab + (static_cast<size_t>(i) * Fin + off) * L;
#pragma unroll
    for (int j = 0; j < SIZE; ++j) cp_async<T>(dst + j * L, row + j * B);
  }
}

template <typename T, int NX, int NU, int NG>
__global__ void __launch_bounds__(kLaneThreads)
fmpc_backward_resident_kernel(FmpcFields<T> f, const T* __restrict__ sT,
                              const T* __restrict__ PT, T* __restrict__ ks,
                              T* __restrict__ Ks, T* __restrict__ sv,
                              T* __restrict__ Ps,
                              unsigned char* __restrict__ ok_out,
                              unsigned char* __restrict__ finite_out, int N,
                              int B, T dt, int break_if_llt_fails,
                              int check_nan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using O = FmpcPackedLayout<NX, NU, NG>;
  const int L = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * L + t;
  if (b >= B) return;
  T* slab = reinterpret_cast<T*>(smem_raw) + t;       // this lane's column

  stage_fmpc_field<T, NX * NX>(f.A, O::A, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NX * NU>(f.Bm, O::Bm, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NG * NX>(f.C, O::C, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NG * NU>(f.D, O::D, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NX * NX>(f.Lxx, O::Lxx, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NU * NU>(f.Luu, O::Luu, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NX * NU>(f.Lxu, O::Lxu, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NX>(f.xb, O::xb, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NX>(f.Lxb, O::Lxb, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NU>(f.Lub, O::Lub, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NG>(f.nu_s, O::nu_s, O::F, N, b, B, slab, L);
  stage_fmpc_field<T, NG>(f.tilde, O::tilde, O::F, N, b, B, slab, L);
  cp_async_commit();

  FmpcCarry<T, NX> c;
  init_fmpc_carry<T, NX>(sT, PT, b, B, c);
  bool fin = store_carry<T, NX>(c, N, b, B, sv, Ps);
  const bool brk = break_if_llt_fails != 0;
  cp_async_wait<0>();

  for (int i = N - 1; i >= 0; --i) {
    FmpcStage<T, NX, NU, NG> cur;
    load_fmpc_packed<T, NX, NU, NG>(slab + static_cast<size_t>(i) * O::F * L,
                                    L, cur);
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
  }
  ok_out[b] = c.ok ? 1 : 0;
  finite_out[b] = (fin || !check_nan) ? 1 : 0;
}

// Launch on `stream` with N * Fin * 32 scalars of dynamic shared memory
// (the opt-in above 48 KB is set here); returns the CUDA error of the
// attribute call or cudaGetLastError() after the launch.  Arguments as
// the wrapper passes them (kernels/fmpc_backward.py): fields A, B, C, D,
// Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, nu_s, tilde [N, ..., B], sT [NX,
// B], PT [NX, NX, B], the outputs as K8's.
template <typename T, int NX, int NU, int NG>
int launch_fmpc_backward_resident(int N, int B, double dt,
                                  int break_if_llt_fails, int check_nan,
                                  const void* const* fields, const void* sT,
                                  const void* PT, void* ks, void* Ks,
                                  void* sv, void* Ps, void* ok, void* finite,
                                  void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const FmpcFields<T> f{at(0), at(1), at(2), at(3), at(4),  at(5),
                        at(6), at(7), at(8), at(9), at(10), at(11)};
  const size_t smem = static_cast<size_t>(N) *
                      FmpcPackedLayout<NX, NU, NG>::F * kLaneThreads *
                      sizeof(T);
  const int err = allow_dynamic_smem(
      fmpc_backward_resident_kernel<T, NX, NU, NG>, smem);
  if (err != 0) return err;
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  fmpc_backward_resident_kernel<T, NX, NU, NG>
      <<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(sT), static_cast<const T*>(PT),
          static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(sv),
          static_cast<T*>(Ps), static_cast<unsigned char*>(ok),
          static_cast<unsigned char*>(finite), N, B, static_cast<T>(dt),
          break_if_llt_fails, check_nan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

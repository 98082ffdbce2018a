// Fused DDP Riccati backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas (stage-DMA mode: _backward_pallas_call, kernel
// _make_kernel, stage body _riccati_stage with _chol_t/_chol_solve_t).
// Its plain twin is nmpc_tpu_torch/kernels/ddp_backward.py::
// backward_stacked; the math and the order of each sum follow
// _riccati_stage.
//
// What bounds it on the card: the latency of each lane's chain of N
// dependent stages, not device memory.  Per stage and lane it reads the
// seven derivative fields (46 values at nx=4, nu=1) and writes k and K (5
// values), ~84 MB at B=4096, N=100, in ~0.16 ms: 0.5 TB/s of the H100's
// 3.35.  A stage takes a lane ~1.3-1.6 us whether an SM holds one lane or
// 32 (PERF.md): its ~700 instructions issue from one warp, one at a time
// behind their dependences.  The packed kernel (ddp_backward_packed.cuh)
// splits the stage over a group of threads per lane; this one keeps one
// thread per lane.
//
// What the design does about it:
//   * one thread per lane, the (Vx, Vxx, dV, ok) carry in registers, and
//     the N-stage recursion as a loop inside the thread (the TPU kernel's
//     sequential fori_loop); nothing but k and K goes back to memory;
//   * the batch-minor [N, dims..., B] layout makes every field load
//     coalesced across a warp;
//   * stage i-1's fields are loaded into registers before stage i is
//     computed (the TPU kernel's double-buffered stage DMA), so the loads
//     of the next stage are in flight during this stage's arithmetic;
//   * 32-thread blocks spread the few lanes over as many SMs as possible.
// No shared memory is used.  Templated on the scalar type (float, double)
// and on (NX, NU); the wrapper (kernels/ddp_backward_fused.py) instantiates
// it per (dtype, nx, nu) in a small generated unit.  The stage body
// (riccati_stage, cholesky, neg_chol_solve) lives in riccati_stage.cuh,
// shared with the other DDP backward kernels, as the TPU kernels share
// _riccati_stage / _chol_t / _chol_solve_t.  The helpers below (carry,
// gains, packed stage) are shared with the chunked (K2,
// ddp_backward_chunked.cuh) and packed (K3, ddp_backward_packed.cuh)
// variants.

#pragma once

#include "remat_common.cuh"
#include "riccati_stage.cuh"

namespace nmpc {

// The seven derivative fields, each a batch-minor [N, n, m, B] array.
template <typename T>
struct DerivFields {
  const T* __restrict__ Fx;
  const T* __restrict__ Fu;
  const T* __restrict__ Lx;
  const T* __restrict__ Lu;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_stage(const DerivFields<T>& f, int i,
                                           int b, int B, Stage<T, NX, NU>& s) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.Fx[a][c] = f.Fx[idx3(i, a, c, NX, NX, b, B)];
      s.Lxx[a][c] = f.Lxx[idx3(i, a, c, NX, NX, b, B)];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Fu[a][c] = f.Fu[idx3(i, a, c, NX, NU, b, B)];
      s.Lxu[a][c] = f.Lxu[idx3(i, a, c, NX, NU, b, B)];
    }
    s.Lx[a] = f.Lx[idx2(i, a, NX, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lu[a] = f.Lu[idx2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f.Luu[idx3(i, a, c, NU, NU, b, B)];
  }
}

// One stage of one lane from a packed slab: value e of the stage at
// p[e * stride] (device memory: stride B; a shared-memory chunk: stride
// the block's lane count).
template <typename T, int NX, int NU>
__device__ __forceinline__ void load_stage_packed(const T* __restrict__ p,
                                                  size_t stride,
                                                  Stage<T, NX, NU>& s) {
  using P = PackedLayout<NX, NU>;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.Fx[a][c] = p[(P::Fx + a * NX + c) * stride];
      s.Lxx[a][c] = p[(P::Lxx + a * NX + c) * stride];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Fu[a][c] = p[(P::Fu + a * NU + c) * stride];
      s.Lxu[a][c] = p[(P::Lxu + a * NU + c) * stride];
    }
    s.Lx[a] = p[(P::Lx + a) * stride];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lu[a] = p[(P::Lu + a) * stride];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = p[(P::Luu + a * NU + c) * stride];
  }
}

// The terminal carry (Vx_T, Vxx_T, dV = 0, ok) of lane b.
template <typename T, int NX>
__device__ __forceinline__ void init_carry(const T* __restrict__ VxT,
                                           const T* __restrict__ VxxT, int b,
                                           int B, Carry<T, NX>& carry) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    carry.Vx[a] = VxT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      carry.Vxx[a][e] = VxxT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  carry.dV0 = T(0);
  carry.dV1 = T(0);
  carry.ok = true;
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void store_gains(const T (&k)[NU],
                                            const T (&K)[NU][NX], int i,
                                            int b, int B, T* __restrict__ ks,
                                            T* __restrict__ Ks) {
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    ks[idx2(i, a, NU, b, B)] = k[a];
#pragma unroll
    for (int e = 0; e < NX; ++e) Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
  }
}

template <typename T, int NX>
__device__ __forceinline__ void store_result(const Carry<T, NX>& carry, int b,
                                             int B, T* __restrict__ dV,
                                             unsigned char* __restrict__ ok) {
  dV[b] = carry.dV0;
  dV[static_cast<size_t>(B) + b] = carry.dV1;
  ok[b] = carry.ok ? 1 : 0;
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
ddp_backward_kernel(DerivFields<T> f, const T* __restrict__ VxT,
                    const T* __restrict__ VxxT, const T* __restrict__ lam_in,
                    T* __restrict__ ks, T* __restrict__ Ks,
                    T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                    int N, int B, int reg_type) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Carry<T, NX> carry;
  init_carry<T, NX>(VxT, VxxT, b, B, carry);
  const T lam = lam_in[b];

  Stage<T, NX, NU> cur, nxt;
  load_stage<T, NX, NU>(f, N - 1, b, B, cur);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_stage<T, NX, NU>(f, i - 1, b, B, nxt);
    T k[NU], K[NU][NX];
    riccati_stage<T, NX, NU>(cur, lam, reg_type, carry, k, K);
    store_gains<T, NX, NU>(k, K, i, b, B, ks, Ks);
    cur = nxt;
  }
  store_result<T, NX>(carry, b, B, dV, ok_out);
}

// Launch on `stream`; returns cudaGetLastError() after the launch.  All
// arrays are contiguous batch-minor device arrays; ok is one byte per
// lane.  fields: Fx, Fu, Lx, Lu, Lxx, Luu, Lxu.
template <typename T, int NX, int NU>
int launch_ddp_backward(int N, int B, int reg_type,
                        const void* const* fields, const void* VxT,
                        const void* VxxT, const void* lam, void* ks, void* Ks,
                        void* dV, void* ok, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const DerivFields<T> f{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  ddp_backward_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), static_cast<T*>(ks),
          static_cast<T*>(Ks), static_cast<T*>(dV),
          static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

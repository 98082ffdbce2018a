// Fused DDP Riccati backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas (stage-DMA mode: _backward_pallas_call, kernel
// _make_kernel, stage body _riccati_stage with _chol_t/_chol_solve_t).
// Its plain twin is nmpc_tpu_torch/kernels/ddp_backward.py::
// backward_stacked; the math and the order of each sum follow
// _riccati_stage.
//
// What bounds it on the card: device memory.  Per stage and lane it reads
// the seven derivative fields (46 values at nx=4, nu=1) and writes k and
// K (5 values), against roughly 10 flops per value read: far below the
// H100's flop/byte ridge.  One thread per lane at B=4096 is only 4096
// threads, too few loads in flight to reach full bandwidth, so the kernel
// runs latency-limited below the roofline.
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
// and on (NX, NU); the instantiated pairs are listed in
// ddp_backward_launch below.  The stage body (riccati_stage, cholesky,
// neg_chol_solve) lives in riccati_stage.cuh, shared with the remat
// backward (ddp_backward_remat.cuh), as the TPU kernels share
// _riccati_stage / _chol_t / _chol_solve_t.

#include <cuda_runtime.h>

#include <cstddef>

#include "riccati_stage.cuh"

namespace {

using namespace nmpc;

constexpr int kThreads = 32;

template <typename T, int NX, int NU>
struct Fields {
  const T* __restrict__ Fx;
  const T* __restrict__ Fu;
  const T* __restrict__ Lx;
  const T* __restrict__ Lu;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
};

// Element (i, a, c, b) of a batch-minor [N, n, m, B] field.
__device__ __forceinline__ size_t at3(int i, int a, int c, int n, int m,
                                      int b, int B) {
  return ((static_cast<size_t>(i) * n + a) * m + c) * B + b;
}

__device__ __forceinline__ size_t at2(int i, int a, int n, int b, int B) {
  return (static_cast<size_t>(i) * n + a) * B + b;
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_stage(Stage<T, NX, NU>& s,
                                           const Fields<T, NX, NU>& f,
                                           int i, int b, int B) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.Fx[a][c] = f.Fx[at3(i, a, c, NX, NX, b, B)];
      s.Lxx[a][c] = f.Lxx[at3(i, a, c, NX, NX, b, B)];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Fu[a][c] = f.Fu[at3(i, a, c, NX, NU, b, B)];
      s.Lxu[a][c] = f.Lxu[at3(i, a, c, NX, NU, b, B)];
    }
    s.Lx[a] = f.Lx[at2(i, a, NX, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lu[a] = f.Lu[at2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f.Luu[at3(i, a, c, NU, NU, b, B)];
  }
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads)
ddp_backward_kernel(Fields<T, NX, NU> f, const T* __restrict__ VxT,
                    const T* __restrict__ VxxT, const T* __restrict__ lam_in,
                    T* __restrict__ ks, T* __restrict__ Ks,
                    T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                    int N, int B, int reg_type) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Carry<T, NX> carry;
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
  const T lam = lam_in[b];

  Stage<T, NX, NU> cur, nxt;
  load_stage(cur, f, N - 1, b, B);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_stage(nxt, f, i - 1, b, B);
    T k[NU], K[NU][NX];
    riccati_stage<T, NX, NU>(cur, lam, reg_type, carry, k, K);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      ks[at2(i, a, NU, b, B)] = k[a];
#pragma unroll
      for (int e = 0; e < NX; ++e) Ks[at3(i, a, e, NU, NX, b, B)] = K[a][e];
    }
    cur = nxt;
  }
  dV[b] = carry.dV0;
  dV[static_cast<size_t>(B) + b] = carry.dV1;
  ok_out[b] = carry.ok ? 1 : 0;
}

template <typename T, int NX, int NU>
int launch(int N, int B, int reg_type, const void* Fx, const void* Fu,
           const void* Lx, const void* Lu, const void* Lxx, const void* Luu,
           const void* Lxu, const void* VxT, const void* VxxT,
           const void* lam, void* ks, void* Ks, void* dV, void* ok,
           cudaStream_t stream) {
  Fields<T, NX, NU> f{
      static_cast<const T*>(Fx),  static_cast<const T*>(Fu),
      static_cast<const T*>(Lx),  static_cast<const T*>(Lu),
      static_cast<const T*>(Lxx), static_cast<const T*>(Luu),
      static_cast<const T*>(Lxu)};
  const int blocks = (B + kThreads - 1) / kThreads;
  ddp_backward_kernel<T, NX, NU><<<blocks, kThreads, 0, stream>>>(
      f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
      static_cast<const T*>(lam), static_cast<T*>(ks), static_cast<T*>(Ks),
      static_cast<T*>(dV), static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward pass on `stream`; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a (dtype, nx, nu) that is not
// instantiated here.  dtype_code: 0 float, 1 double.  All arrays are
// contiguous batch-minor device arrays; ok is one byte per lane.
extern "C" int ddp_backward_launch(int dtype_code, int nx, int nu,
                                   int reg_type, int N, int B,
                                   const void* Fx, const void* Fu,
                                   const void* Lx, const void* Lu,
                                   const void* Lxx, const void* Luu,
                                   const void* Lxu, const void* VxT,
                                   const void* VxxT, const void* lam,
                                   void* ks, void* Ks, void* dV, void* ok,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nx == 4 && nu == 1) {
    if (dtype_code == 0)
      return launch<float, 4, 1>(N, B, reg_type, Fx, Fu, Lx, Lu, Lxx, Luu,
                                 Lxu, VxT, VxxT, lam, ks, Ks, dV, ok, s);
    if (dtype_code == 1)
      return launch<double, 4, 1>(N, B, reg_type, Fx, Fu, Lx, Lu, Lxx, Luu,
                                  Lxu, VxT, VxxT, lam, ks, Ks, dV, ok, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

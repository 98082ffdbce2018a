// Packed-input DDP Riccati backward for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// _backward_pallas_call_packed (kernel _make_kernel_packed): K1's
// recursion (ddp_backward.cuh) with every stage's seven derivative fields
// read from one packed [N, F, B] buffer, field order and offsets of
// _field_offsets (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, each row-major; F = 46 at
// (nx, nu) = (4, 1), 16 at (2, 1)).  The wrapper builds the buffer with
// kernels/ddp_backward_fused.py::pack_derivs; its plain version unpacks
// it and runs backward_stacked.
//
// What bounds it on the card: the same as K1, device memory read by too
// few threads (one per lane) to keep enough loads in flight; the pack
// that builds its input costs one more read and write of every field.
//
// What the design does about it: as K1, one thread per lane with the
// carry in registers and the next stage's F values loaded before this
// stage is computed, now from one contiguous [F, B] slab per stage (the
// TPU kernel's one DMA per stage), so the F loads of a warp walk one
// array at stride B instead of seven.  The stage is riccati_stage.cuh::
// riccati_stage, unchanged, so the result equals K1's bit for bit.

#pragma once

#include "ddp_backward.cuh"

namespace nmpc {

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
ddp_backward_packed_kernel(const T* __restrict__ P, const T* __restrict__ VxT,
                           const T* __restrict__ VxxT,
                           const T* __restrict__ lam_in, T* __restrict__ ks,
                           T* __restrict__ Ks, T* __restrict__ dV,
                           unsigned char* __restrict__ ok_out, int N, int B,
                           int reg_type) {
  constexpr int F = PackedLayout<NX, NU>::F;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Carry<T, NX> carry;
  init_carry<T, NX>(VxT, VxxT, b, B, carry);
  const T lam = lam_in[b];
  const size_t stage = static_cast<size_t>(F) * B;

  Stage<T, NX, NU> cur, nxt;
  load_stage_packed<T, NX, NU>(P + (N - 1) * stage + b, B, cur);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_stage_packed<T, NX, NU>(P + (i - 1) * stage + b, B, nxt);
    T k[NU], K[NU][NX];
    riccati_stage<T, NX, NU>(cur, lam, reg_type, carry, k, K);
    store_gains<T, NX, NU>(k, K, i, b, B, ks, Ks);
    cur = nxt;
  }
  store_result<T, NX>(carry, b, B, dV, ok_out);
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
// fields[0] is the packed [N, F, B] buffer; the rest as K1's launch.
template <typename T, int NX, int NU>
int launch_ddp_backward_packed(int N, int B, int reg_type,
                               const void* const* fields, const void* VxT,
                               const void* VxxT, const void* lam, void* ks,
                               void* Ks, void* dV, void* ok, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  ddp_backward_packed_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(fields[0]), static_cast<const T*>(VxT),
          static_cast<const T*>(VxxT), static_cast<const T*>(lam),
          static_cast<T*>(ks), static_cast<T*>(Ks), static_cast<T*>(dV),
          static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc

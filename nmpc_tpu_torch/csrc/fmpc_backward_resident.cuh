// Resident FMPC condensed Riccati backward for Hopper (sm_90a): the whole
// horizon of a block's lanes in shared memory.
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_backward_pallas.py::
// _fmpc_backward_pallas_call_resident (kernel _make_kernel_resident):
// K8's recursion for short horizons, N <= 32 (kResidentMaxN), with K8's
// inputs and outputs.  It is K8's kernel (fmpc_backward.cuh::
// fmpc_backward_kernel at CH = 0): the same loop (fmpc_group_backward, a
// group of G threads per lane on fmpc_stage_group, the (s, nu)
// condensation formed by the group from s, nu, g_bar, the masks and eps),
// so its result equals K8's bit for bit (both built with -fmad=false), and
// its wrapper makes one launch.
//
// What bounds it on the card: the per-lane dependent chain of N stages,
// and at a short horizon the latency of the first loads: a kernel that
// streams the stages waits on a chunk's fields before it can start it.
//
// What the design does about it: the producer warp issues the 13 TMA boxes
// of the block's whole horizon at once ([L lanes, size, N stages] each,
// one per field and thread, landed in K8's stage layout), so every load of
// the block is in flight together; the consumers wait once and run the
// recursion from shared memory.  The footprint is N F L scalars a block (F
// K8's padded stage: 56 at the oscillator's (2, 1, 3), 88 at the
// cart-pole's (4, 1, 4), fp32), so the lanes per block come from the shape
// (fmpc_group.cuh::fmpc_resident_lanes: row_lanes, halved while the
// horizon passes 227 KB) and kernels/fmpc_backward.py::resident_fits says
// which shapes fit at the fewest lanes.  A field TMA does not take as it
// is (B = 1023 at fp32, a view at an offset) is copied once by the
// wrapper, as for K8.

#pragma once

#include "fmpc_backward.cuh"

namespace nmpc {

// Launch on `stream` with `lanes` lanes a block (0: fmpc_resident_lanes);
// arguments and the returned CUDA error as launch_fmpc_backward's
// (cudaErrorInvalidValue where the horizon does not fit a block, or
// `lanes` is not a whole number of warps' lanes of at least 4 and at most
// 32).
template <typename T, int NX, int NU, int NG, int G = kFmpcGroup<NX, NU>,
          bool SHARE = kFmpcShare<NX>>
int launch_fmpc_backward_resident(int lanes, int N, int B, int ld, double dt,
                                  int break_if_llt_fails, int check_nan,
                                  const void* const* fields, const void* gms,
                                  int gms_ld, const void* eps,
                                  const void* LxT, const void* PT, void* ks,
                                  void* Ks, void* sv, void* Ps, void* ok,
                                  void* finite, void* stream) {
  using Layout = FmpcStreamLayout<T, NX, NU, NG, G>;
  if (B <= 0 || !fmpc_resident_fits<T, G>(Layout::F, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int L =
      lanes > 0 ? lanes : fmpc_resident_lanes<T, G>(Layout::F, N, B);
  if (L < 4 || L > kMaxRowLanes || L % (32 / G) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fmpc_group<T, NX, NU, NG, G, SHARE, 0>(
      L, N, N, B, ld, dt, break_if_llt_fails, check_nan, fields, gms, gms_ld,
      eps, LxT, PT, ks, Ks, sv, Ps, ok, finite, stream);
}

}  // namespace nmpc

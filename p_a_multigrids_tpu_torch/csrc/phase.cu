// K1: one round of a block-Jacobi / Chebyshev relaxation phase of the
// semi-structured DG block stencil, for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of p_a_multigrids_tpu/ops/pallas_stencil.py,
// which each ran a whole phase of R rounds in one pallas_call over a
// (rounds x macro tiles) grid:
// - PhaseOperator._kernel (as configured by PhaseOperatorCoefResident), the
//   phase at C <= 64 children per macro (n_split <= 3);
// - PhaseOperatorResident._kernel, the same phase at C > 64 (n_split 4 and
//   5, C = 256 and 1024).  It re-indexed the children onto a padded square
//   lattice (Cp = 2 * 4^s rows) so that intra-macro neighbors sat at fixed
//   sublane shifts with up/down masks, and packed the boundary strips with
//   a one-hot matmul, because a gather through a child table of length C
//   cost O(C^2) one-hot work on the TPU's matrix unit.  Here a gather
//   through the `intra` table costs O(1) per child at any C, so one kernel
//   covers every depth: no lattice, padding, masks or strip packing.
//
// What one round computes, for every child c of every macro u and dof i:
//   acc_i = sum_f sum_j Fp[f,i,j,c,u] * x[j, nb_f(c), u]
//         + sum_{slots s of c} sum_j Xp[i,j,s,u] * x[j, src(s,u)]
//   z_i   = bp_i - x_i - acc_i              (= D^-1 (b - A x))
//   x'_i  = x_i + coef * z_i
// reading only the previous round's state (Jacobi semantics: x and x_out
// are distinct buffers).  Fp = D^-1 F and Xp = D^-1 X are premultiplied
// blocks; nb_f(c) is the intra-macro neighbor (the child itself on a macro
// boundary face, where Fp is zero); src(s, u) is the cross-macro source of
// slot s as an offset c_src*U + u_src in a (C, U) plane.
//
// Layout: state (3, C, U), Fp (3f, 3i, 3j, C, U), Xp (3i, 3j, nb, U),
// src (nb, U).  One thread owns one (c, u) pair and writes its three dofs;
// u is the fastest index, so coefficient planes and state read coalesced.
//
// What bounds it on an H100: bytes and launches.  At the stand-in mesh's
// level 0 (U = 8192, C = 16, f32) one round reads 27*C*U*4 B = 14.2 MB of
// Fp, 9*nb*U*4 B = 3.5 MB of Xp (nb = 12 slots) and moves about 6 MB of x,
// bp, x_out and z: some 24 MB, which fits the 50 MB L2, so a round of a
// phase can find the coefficients of the round before still cached.  From
// device memory at 3.35 TB/s that is about 7 us a round; at a few
// microseconds of work per launch, the launch count of a phase (one per
// round) weighs as much as the bandwidth.
//
// At C = 1024 (the level sweep's finest level, n_split 5, U = 96) Fp is
// 27*C*U*4 B = 10.6 MB and x, bp, x_out and z another 4.7 MB: the round is
// bandwidth-bound from L2 once a phase has warmed it, and its 98,304
// threads (384 blocks) fit on the 132 SMs in one partial wave.  Child c's
// intra neighbors lie within 2^(s+1) - 2 rows of c in the row-major child
// order (62 rows at s = 5), so their x reads hit lines that nearby blocks
// have just brought into L2.
//
// Index bounds.  All offsets into the (3, C, U) state and the coefficient
// planes are computed in 64 bits.  The tables are int32: `intra` holds
// child ids < C, and `src` holds c_src*U + u_src < C*U, so the kernel needs
// C*U < 2^31.  The largest shape the CLI reaches on a generated mesh in
// practice, n_split 5 with --rows 24 --cols 24 (U = 1152), has
// C*U = 1,179,648; the bound is 1,820 times that, and a level at the bound
// would hold 232 GB of Fp, more than the card, so allocating its
// coefficients fails before any launch and the wrapper does not check it.
//
// What this design does about the bytes and launches: nothing yet.  It is
// the simple correct kernel, one launch per round.  A persistent
// cooperative kernel with a grid barrier between rounds, or CUDA-graph
// capture of a phase, comes in a later change.

#include <cuda_runtime.h>

namespace {

__global__ void phase_round_kernel(
    const float* __restrict__ x, const float* __restrict__ bp,
    const float* __restrict__ Fp, const float* __restrict__ Xp,
    const int* __restrict__ intra, const int* __restrict__ slot_ptr,
    const int* __restrict__ slot_idx, const int* __restrict__ src,
    float* __restrict__ x_out, float* __restrict__ z_out, float coef,
    int C, int U, int nb) {
  const long long CU = static_cast<long long>(C) * U;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= CU) return;
  const int c = static_cast<int>(t / U);
  const int u = static_cast<int>(t - static_cast<long long>(c) * U);

  // intra-macro neighbor values x[j, nb_f(c), u]
  float xn[3][3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const long long q = static_cast<long long>(intra[f * C + c]) * U + u;
#pragma unroll
    for (int j = 0; j < 3; ++j) xn[f][j] = x[j * CU + q];
  }

  float acc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a += Fp[((f * 3 + i) * 3 + j) * CU + t] * xn[f][j];
      }
    }
    acc[i] = a;
  }

  // cross-macro slots of child c (two at a corner child, none inside)
  float cross[3] = {0.0f, 0.0f, 0.0f};
  const long long nbU = static_cast<long long>(nb) * U;
  for (int k = slot_ptr[c]; k < slot_ptr[c + 1]; ++k) {
    const int s = slot_idx[k];
    const long long su = static_cast<long long>(s) * U + u;
    const long long g = src[su];
    const float s0 = x[g], s1 = x[CU + g], s2 = x[2 * CU + g];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cross[i] += Xp[(i * 3 + 0) * nbU + su] * s0
                + Xp[(i * 3 + 1) * nbU + su] * s1
                + Xp[(i * 3 + 2) * nbU + su] * s2;
    }
  }

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xi = x[i * CU + t];
    const float z = bp[i * CU + t] - xi - (acc[i] + cross[i]);
    x_out[i * CU + t] = xi + coef * z;
    if (z_out != nullptr) z_out[i * CU + t] = z;
  }
}

}  // namespace

// One relaxation round on `stream`.  z_out may be null (z not wanted).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int k1_phase_round(const void* x, const void* bp, const void* Fp,
                              const void* Xp, const void* intra,
                              const void* slot_ptr, const void* slot_idx,
                              const void* src, void* x_out, void* z_out,
                              float coef, int C, int U, int nb,
                              void* stream) {
  const long long CU = static_cast<long long>(C) * U;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((CU + threads - 1) / threads);
  phase_round_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bp),
      static_cast<const float*>(Fp), static_cast<const float*>(Xp),
      static_cast<const int*>(intra), static_cast<const int*>(slot_ptr),
      static_cast<const int*>(slot_idx), static_cast<const int*>(src),
      static_cast<float*>(x_out), static_cast<float*>(z_out), coef, C, U,
      nb);
  return static_cast<int>(cudaGetLastError());
}

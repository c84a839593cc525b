// K2: fixed-degree 3x3 block-row SpMV on transposed vectors, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel PallasSpMV._kernel in
// p_a_multigrids_tpu/ops/pallas_bsr.py, which ran every block-row operator
// of the smoothed-aggregation (SA) hierarchy (level operators, restrictions,
// prolongations, the fine tentative transfers) as a banded one-hot MXU
// gather over a square padded embedding.
//
// What it computes, for every output block row n and dof i:
//   y[i, n] = sum_d sum_j vals[d, i, j, n] * x[j, cols[d, n]]
// with x of shape (3, S) and y of shape (3, N): square (S = N) for a level
// operator, rectangular for a transfer.  Zero blocks pad short rows and
// point at valid columns, so padded slots are computed like any other
// slot, with no branch.
//
// Layout: cols (D, N) int32, vals (D, 3, 3, N), row index fastest.  One
// thread owns one output row and writes its three dofs, looping over the D
// slots; neighbouring threads read neighbouring addresses of cols and vals.
//
// What bounds it on an H100: bytes.  A slot costs 36 B of vals and 4 B of
// cols, read once, plus the 12 B of x it gathers.  The level-0 operator of
// the production hierarchy on the 393,216-DOF stand-in (N = 32,768 rows,
// D = 13 slots) streams 32,768 * 13 * 40 B = 17 MB of tables a call, about
// 5 us at 3.35 TB/s.  The x gathers stay local: rows follow the fine
// element order, which is banded (RCM-ordered, or a structured mesh's own
// numbering), and SA aggregates are relabeled by their first member, so a
// row's columns sit near each other and near the rows of its neighbours
// and mostly hit L1/L2.
//
// What this design does about it: nothing yet.  It is the simple correct
// kernel: one thread per row, no shared-memory staging of x, no vector
// loads.  Making it fast is later work.

#include <cuda_runtime.h>

namespace {

__global__ void rowop_kernel(const int* __restrict__ cols,
                             const float* __restrict__ vals,
                             const float* __restrict__ x,
                             float* __restrict__ y, int N, int D, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long NN = N;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const long long c = cols[d * NN + n];
    const float x0 = x[c], x1 = x[S + c], x2 = x[2LL * S + c];
    const float* v = vals + d * 9 * NN + n;   // v[(3i + j) * N]
    a0 += v[0 * NN] * x0 + v[1 * NN] * x1 + v[2 * NN] * x2;
    a1 += v[3 * NN] * x0 + v[4 * NN] * x1 + v[5 * NN] * x2;
    a2 += v[6 * NN] * x0 + v[7 * NN] * x1 + v[8 * NN] * x2;
  }
  y[n] = a0;
  y[NN + n] = a1;
  y[2 * NN + n] = a2;
}

}  // namespace

// y (3, N) <- block-row operator (cols, vals) applied to x (3, S), on
// `stream`.  Returns cudaGetLastError() after the launch: 0 when it was
// accepted.
extern "C" int k2_rowop(const void* cols, const void* vals, const void* x,
                        void* y, int N, int D, int S, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((N + threads - 1) / threads);
  rowop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), N, D, S);
  return static_cast<int>(cudaGetLastError());
}

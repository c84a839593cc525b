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
//   y[i, n] = sum_d sum_j vals[n, d, i, j] * x[j, cols[n, d]]
// with x of shape (3, S) and y of shape (3, N): square (S = N) for a level
// operator, rectangular for a transfer.  Zero blocks pad short rows and
// point at valid columns, so padded slots are computed like any other
// slot, with no branch.
//
// What bounds it on an H100: bytes, where there are rows enough to fill
// the card.  A slot costs 36 B of vals and 4 B of cols, read once, plus the
// 12 B of x it gathers.  The level-0 operator of the production hierarchy
// on the 393,216-DOF stand-in (N = 32,768 rows, D = 13 slots) streams
// 17 MB of tables a call, about 5 us at 3.35 TB/s.  The x gathers stay
// local: rows follow the fine element order, which is banded, and SA
// aggregates are relabeled by their first member, so a row's columns sit
// near each other and mostly hit L1/L2.  The coarse SA operators are short
// and wide (513 x 141, 2,047 x 63, 2,047 x 33, 8,223 x 25): one thread per
// row leaves most of the card idle and walks up to 141 slots in sequence,
// so they are latency-bound, 49 us for a 2.9 MB operator.
//
// The design: two variants, chosen per operator by the host
// (ops/spmv.rowop_plan) from D.
// - thread: one thread per row for narrow operators (D < 8).  Tables
//   cols (D, N) int32 and vals (D, 3, 3, N), row index fastest, so the
//   threads of neighbouring rows read neighbouring addresses.
// - lanes: a group of G = 4, 8, 16 or 32 lanes per row for the wider
//   ones, sized from D, the level-0 operator included (5.3 us against 6.3
//   for one thread a row: H100 80GB HBM3, 700 W, utils/profiling.py).  Tables row-major, cols (N, Dp) int32 and vals
//   (N, 3, 3, Dp) with D padded to Dp, a multiple of 4, by zero blocks on
//   a valid column.  Lane l takes the slot quads l, l + G, ...: one 16-byte
//   load of 4 columns and nine 16-byte loads of 4 slots' values from
//   consecutive addresses, and the 12 gathers of x, all independent, so
//   the row's loads are in flight together instead of one slot after the
//   other.  The lanes write each slot's three sums to shared memory and the
//   row's first lane adds them in slot order, as the thread variant does:
//   both variants give the same bits, so the choice of variant never moves
//   a result (a tree of lane partials moved the production amg history by
//   2% at its fourth cycle, within the f32 spread of the solve but outside
//   the check that holds it).  Rows of more than 1,024 slots (48 KB of sums
//   a block) take the thread variant.
//
// Scalar type: both variants are templates on their scalar T, instantiated
// for float32 and float64 (k2_rowop_f32, k2_rowop_f64) with the same
// plan, layouts and summation order.  In float64 a slot costs 72 B of vals
// (twice the bytes), the lanes load each quad of values as two 16-byte
// loads, and a block's slot sums take 24 B a slot, so the lanes variant
// takes rows of up to 512 slots (48 KB of sums a block).
//
// The checked build (-DPAMG_CHECKED, checked.cuh; `--debug`): every column
// a thread reads from `cols` is compared with S, the number of source rows
// it addresses, and every y it writes is tested with isfinite.  The first
// fault goes to the error record and a faulty column reads as 0.  The
// variants, their launch shapes and their arithmetic are the unchecked
// build's.

#include <cuda_runtime.h>

#ifdef PAMG_CHECKED
#include "checked.cuh"
#endif

namespace {

// Where a checked launch records its first fault (checked.cuh); unused by
// the unchecked build.
struct Check {
  int* record;
  int site;
};

// c, column `slot` of row n, if it lies in [0, S); in the checked build a
// fault is recorded and 0 returned otherwise.
__device__ __forceinline__ int in_range(const Check& k, int c, int S,
                                        long long n, int slot) {
#ifdef PAMG_CHECKED
  if (c < 0 || c >= S) {
    pamg_checked::record_fault(k.record, 2, k.site, pamg_checked::kIndex, n,
                               slot, c, S);
    return 0;
  }
#endif
  return c;
}

// In the checked build, records y[i, n] = v unless it is finite (as the
// bits of v converted to float32, which keeps a double Inf or NaN one).
template <typename T>
__device__ __forceinline__ void expect_finite(const Check& k, T v,
                                              long long n, int i) {
#ifdef PAMG_CHECKED
  if (!isfinite(v))
    pamg_checked::record_fault(k.record, 2, k.site,
                               pamg_checked::kNonFinite, n, i,
                               __float_as_int(static_cast<float>(v)), 0);
#endif
}

// Four consecutive values of T, loaded together: one 16-byte load of
// float32, two of float64.
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
struct __align__(16) DoubleQuad { double x, y, z, w; };
template <> struct Quad<double> { using type = DoubleQuad; };

template <typename T>
__global__ void rowop_thread_kernel(const int* __restrict__ cols,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ x,
                                    T* __restrict__ y, int N, int D,
                                    int S, const Check chk) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long NN = N;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int d = 0; d < D; ++d) {
    const long long c = in_range(chk, cols[d * NN + n], S, n, d);
    const T x0 = x[c], x1 = x[S + c], x2 = x[2LL * S + c];
    const T* v = vals + d * 9 * NN + n;   // v[(3i + j) * N]
    a0 += v[0 * NN] * x0 + v[1 * NN] * x1 + v[2 * NN] * x2;
    a1 += v[3 * NN] * x0 + v[4 * NN] * x1 + v[5 * NN] * x2;
    a2 += v[6 * NN] * x0 + v[7 * NN] * x1 + v[8 * NN] * x2;
  }
  expect_finite(chk, a0, n, 0);
  expect_finite(chk, a1, n, 1);
  expect_finite(chk, a2, n, 2);
  y[n] = a0;
  y[NN + n] = a1;
  y[2 * NN + n] = a2;
}

// one slot's three sums, block v[0..9) (3i + j) against x[:, c], written
// as the thread variant writes them, so that both compile to the same
// multiply-adds
template <typename T>
__device__ __forceinline__ void slot_sums(T* out, const T* __restrict__ x,
                                          long long S, int c, T v0, T v1,
                                          T v2, T v3, T v4, T v5, T v6,
                                          T v7, T v8) {
  const T x0 = x[c], x1 = x[S + c], x2 = x[2 * S + c];
  out[0] = v0 * x0 + v1 * x1 + v2 * x2;
  out[1] = v3 * x0 + v4 * x1 + v5 * x2;
  out[2] = v6 * x0 + v7 * x1 + v8 * x2;
}

// G lanes per row; Q = Dp / 4 slot quads a row.  The lanes load the row's
// tables and compute its slots' sums into shared memory `sums`
// ([rows a block][Dp][3]); then the row's first lane adds them up in slot
// order, the thread variant's order, so that both variants give the same
// bits (padding slots add exact zeros).  Rows past N compute row N - 1
// and store nothing, so every lane of a warp reaches __syncwarp.
template <typename T, int G>
__global__ void rowop_lanes_kernel(const int4* __restrict__ cols,
                                   const typename Quad<T>::type* __restrict__
                                       vals,
                                   const T* __restrict__ x,
                                   T* __restrict__ y, int N, int Q,
                                   int S, const Check chk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sums = reinterpret_cast<T*>(smem);
  const long long g = (static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x);
  const long long row = g / G;
  const int lane = static_cast<int>(g % G);
  const long long n = row < N ? row : N - 1;
  const int4* cr = cols + n * Q;
  const typename Quad<T>::type* vr = vals + n * 9 * Q;
  T* rs = sums + static_cast<long long>(threadIdx.x / G) * Q * 12;
  for (int q = lane; q < Q; q += G) {
    const int4 cq = cr[q];
    const int4 c = make_int4(in_range(chk, cq.x, S, n, 4 * q),
                             in_range(chk, cq.y, S, n, 4 * q + 1),
                             in_range(chk, cq.z, S, n, 4 * q + 2),
                             in_range(chk, cq.w, S, n, 4 * q + 3));
    typename Quad<T>::type v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = vr[k * Q + q];
    T* o = rs + q * 12;
    slot_sums(o, x, S, c.x, v[0].x, v[1].x, v[2].x, v[3].x, v[4].x, v[5].x,
              v[6].x, v[7].x, v[8].x);
    slot_sums(o + 3, x, S, c.y, v[0].y, v[1].y, v[2].y, v[3].y, v[4].y,
              v[5].y, v[6].y, v[7].y, v[8].y);
    slot_sums(o + 6, x, S, c.z, v[0].z, v[1].z, v[2].z, v[3].z, v[4].z,
              v[5].z, v[6].z, v[7].z, v[8].z);
    slot_sums(o + 9, x, S, c.w, v[0].w, v[1].w, v[2].w, v[3].w, v[4].w,
              v[5].w, v[6].w, v[7].w, v[8].w);
  }
  __syncwarp();
  if (lane == 0 && row < N) {
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int d = 0; d < 4 * Q; ++d) {
      a0 += rs[3 * d];
      a1 += rs[3 * d + 1];
      a2 += rs[3 * d + 2];
    }
    expect_finite(chk, a0, n, 0);
    expect_finite(chk, a1, n, 1);
    expect_finite(chk, a2, n, 2);
    y[n] = a0;
    y[static_cast<long long>(N) + n] = a1;
    y[2LL * N + n] = a2;
  }
}

template <typename T, int G>
cudaError_t launch_lanes(const void* cols, const void* vals, const void* x,
                         void* y, int N, int Q, int S, cudaStream_t s,
                         const Check chk) {
  const int threads = 128;
  const long long total = static_cast<long long>(N) * G;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads / G) * Q * 12 * sizeof(T);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  rowop_lanes_kernel<T, G><<<blocks, threads, smem, s>>>(
      static_cast<const int4*>(cols),
      static_cast<const typename Quad<T>::type*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), N, Q, S, chk);
  return cudaSuccess;
}

template <typename T>
int launch_rowop(const void* cols, const void* vals, const void* x, void* y,
                 int N, int D, int S, int lanes, void* stream, void* record,
                 int site) {
  if (N <= 0) return 0;
#ifdef PAMG_CHECKED
  if (record == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
  const Check chk{static_cast<int*>(record), site};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 1) {
    const int threads = 256;
    const unsigned int blocks =
        static_cast<unsigned int>((N + threads - 1) / threads);
    rowop_thread_kernel<T><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const T*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), N, D, S, chk);
  } else {
    cudaError_t err = cudaErrorInvalidValue;
    if (D % 4 != 0) {
      // the 16-byte loads need whole quads of slots
    } else if (lanes == 4) {
      err = launch_lanes<T, 4>(cols, vals, x, y, N, D / 4, S, s, chk);
    } else if (lanes == 8) {
      err = launch_lanes<T, 8>(cols, vals, x, y, N, D / 4, S, s, chk);
    } else if (lanes == 16) {
      err = launch_lanes<T, 16>(cols, vals, x, y, N, D / 4, S, s, chk);
    } else if (lanes == 32) {
      err = launch_lanes<T, 32>(cols, vals, x, y, N, D / 4, S, s, chk);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (3, N) <- block-row operator (cols, vals) applied to x (3, S), on
// `stream`.  lanes = 1: the thread variant, tables (D, N) / (D, 3, 3, N);
// lanes = 4, 8, 16 or 32: the lane-group variant, tables (N, D) /
// (N, 3, 3, D) with D a multiple of 4.  vals, x and y are float32
// (k2_rowop_f32) or float64 (k2_rowop_f64), cols int32.  The checked build
// records its first fault in `record` (checked.cuh) as operator `site`; the
// unchecked build ignores both.  Returns cudaGetLastError() after the
// launch: 0 when it was accepted.
extern "C" int k2_rowop_f32(const void* cols, const void* vals,
                            const void* x, void* y, int N, int D, int S,
                            int lanes, void* stream, void* record,
                            int site) {
  return launch_rowop<float>(cols, vals, x, y, N, D, S, lanes, stream,
                             record, site);
}

extern "C" int k2_rowop_f64(const void* cols, const void* vals,
                            const void* x, void* y, int N, int D, int S,
                            int lanes, void* stream, void* record,
                            int site) {
  return launch_rowop<double>(cols, vals, x, y, N, D, S, lanes, stream,
                              record, site);
}

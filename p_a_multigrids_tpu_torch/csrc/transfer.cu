// The geometric level transfers of the semi-structured multigrid cycle, for
// NVIDIA Hopper (sm_90a): the restriction P^T with the residual fused in,
// and the prolongation P with the correction's add fused in.
//
// Replaces no TPU kernel.  The JAX package wrote the transfers as XLA
// contractions (models/semi.py restrict_t, prolong_t), and the port ran
// them as PyTorch ops: on the phase cycle each visit of a non-coarsest
// level turned the smoother's z into the residual (a broadcast mul and a
// sum), restricted it (a batched einsum, a gather and a sum) and
// prolonged the coarse correction (a gather, a batched einsum, a copy and
// the add): about 9 kernels of 2-3 us each on at most 1.2 MB, plus the gap
// between them, for two transfers whose bytes take 2.3 us at 3.35 TB/s at
// the finest level.  A 6-level W-cycle makes 15 such visits.
//
// What the two kernels compute, in the transposed layout (3, C, U), with
// the transfer tables of ops/transfer.py (fine_of (Cc, 4), parent (Cf,),
// pweights (Cf, 3, 3), Cf = 4 Cc):
//   restrict:     bc[k, cc, u] = sum_{m<4} sum_l pw[f, l, k] * r_l(f, u),
//                 f = fine_of[cc, m], r_l(f, u) = sum_j S[l, j, f, u] z[j, f, u]
//                 (the residual b - A x = D z from a phase's z and the self
//                 blocks D = S), or r_l = r[l, f, u] where no S is given;
//   prolong_add:  out[l, f, u] = x[l, f, u]
//                               + sum_k pw[f, l, k] * e[k, parent[f], u].
//
// What bounds them on an H100: bytes at the fine level, latency at the
// coarse ones.  The restriction reads S (9 values a pair) and z (3) once
// and writes 3 values a coarse pair: 5.1 MB at C = 1024, U = 96 in float32
// (1.5 us at 3.35 TB/s); the prolongation reads x (3 a pair), e and writes
// out (3): 2.7 MB there (0.8 us).  At C = 4 or 16 on 96 macros a call
// moves a few KB: a launch and a chain of dependent loads (the table, then
// what it indexes).
//
// The design: one thread per output pair, flat index t = c*U + u with u
// fastest, so the threads of a warp read neighbouring addresses of every
// plane of z, S, x and out; the four children of a coarse pair and the
// parent of a fine pair are the same for runs of U threads, so the table
// and pweights reads are broadcasts from L1.  (Loading all four children
// before the first add gave the same times: the compiler schedules the
// loop's loads together either way.)  Each thread sums in a fixed
// order (children m = 0..3, dofs l = 0..2), with no atomics and no
// shared memory: the result is deterministic and the same for any U, so
// a rank-local restriction of a block of macros gives the serial bits.
//
// Scalar type: templates on T, instantiated for float32 and float64
// (transfer_restrict_f32 / _f64, transfer_prolong_add_f32 / _f64) with the
// same arithmetic.  The tables are int64 (the solver's buffers); their
// ranges are checked once when the solver is built (ops/transfer.py
// check_tables), so no index the kernels read comes from runtime data.
// Plane offsets are computed in 64 bits, offsets inside a (C, U) plane in
// 32: the host refuses Cf*U >= 2^31.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T, bool kSelf>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const T* __restrict__ r, const T* __restrict__ S,
                    const long long* __restrict__ fine_of,
                    const T* __restrict__ pw, T* __restrict__ bc, int Cf,
                    int Cc, int U) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= Cc * U) return;
  const int cc = t / U;
  const int u = t - cc * U;
  const long long plane = static_cast<long long>(Cf) * U;
  T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int f = static_cast<int>(fine_of[4 * cc + m]);
    const int o = f * U + u;
    T z[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) z[j] = r[j * plane + o];
    T res[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      if (kSelf) {
        const T* s = S + 3 * l * plane + o;        // S[l, j, f, u]
        res[l] = s[0] * z[0] + s[plane] * z[1] + s[2 * plane] * z[2];
      } else {
        res[l] = z[l];
      }
    }
    const T* w = pw + 9 * f;                       // w[3 l + k]
#pragma unroll
    for (int k = 0; k < 3; ++k)
      acc[k] += w[k] * res[0] + w[3 + k] * res[1] + w[6 + k] * res[2];
  }
  const long long cplane = static_cast<long long>(Cc) * U;
#pragma unroll
  for (int k = 0; k < 3; ++k) bc[k * cplane + t] = acc[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_add_kernel(const T* __restrict__ x, const T* __restrict__ e,
                       const long long* __restrict__ parent,
                       const T* __restrict__ pw, T* __restrict__ out, int Cf,
                       int Cc, int U) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= Cf * U) return;
  const int f = t / U;
  const int u = t - f * U;
  const long long plane = static_cast<long long>(Cf) * U;
  const long long cplane = static_cast<long long>(Cc) * U;
  const int oc = static_cast<int>(parent[f]) * U + u;
  const T e0 = e[oc], e1 = e[cplane + oc], e2 = e[2 * cplane + oc];
  const T* w = pw + 9 * f;                         // w[3 l + k]
#pragma unroll
  for (int l = 0; l < 3; ++l)
    out[l * plane + t] =
        x[l * plane + t] + (w[3 * l] * e0 + w[3 * l + 1] * e1
                            + w[3 * l + 2] * e2);
}

// The launch shape of Cf*U fine pairs, or an error for a shape the
// kernels' 32-bit plane offsets do not take.
cudaError_t check_shape(int Cf, int U) {
  if (Cf <= 0 || Cf % 4 != 0 || U <= 0
      || static_cast<long long>(Cf) * U > INT_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_restrict(const void* r, const void* S, const void* fine_of,
                    const void* pw, void* bc, int Cf, int U, void* stream) {
  cudaError_t err = check_shape(Cf, U);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cc = Cf / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* rt = static_cast<const T*>(r);
  const auto* ft = static_cast<const long long*>(fine_of);
  const T* wt = static_cast<const T*>(pw);
  T* out = static_cast<T*>(bc);
  if (S != nullptr)
    restrict_kernel<T, true><<<blocks(1LL * Cc * U), kThreads, 0, s>>>(
        rt, static_cast<const T*>(S), ft, wt, out, Cf, Cc, U);
  else
    restrict_kernel<T, false><<<blocks(1LL * Cc * U), kThreads, 0, s>>>(
        rt, nullptr, ft, wt, out, Cf, Cc, U);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prolong_add(const void* x, const void* e, const void* parent,
                       const void* pw, void* out, int Cf, int U,
                       void* stream) {
  cudaError_t err = check_shape(Cf, U);
  if (err != cudaSuccess) return static_cast<int>(err);
  prolong_add_kernel<T><<<blocks(1LL * Cf * U), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const long long*>(parent), static_cast<const T*>(pw),
      static_cast<T*>(out), Cf, Cf / 4, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bc (3, Cf/4, U) <- P^T (S z), or P^T r when S is null, on `stream`: r
// (3, Cf, U), S (3, 3, Cf, U), fine_of (Cf/4, 4) int64, pw (Cf, 3, 3).
// Every array contiguous, float32 (_f32) or float64 (_f64) but the table.
// Returns the launch's CUDA error code, 0 when it was accepted.
extern "C" int transfer_restrict_f32(const void* r, const void* S,
                                     const void* fine_of, const void* pw,
                                     void* bc, int Cf, int U, void* stream) {
  return launch_restrict<float>(r, S, fine_of, pw, bc, Cf, U, stream);
}

extern "C" int transfer_restrict_f64(const void* r, const void* S,
                                     const void* fine_of, const void* pw,
                                     void* bc, int Cf, int U, void* stream) {
  return launch_restrict<double>(r, S, fine_of, pw, bc, Cf, U, stream);
}

// out (3, Cf, U) <- x + P e on `stream`: x (3, Cf, U), e (3, Cf/4, U),
// parent (Cf,) int64, pw (Cf, 3, 3); out may not alias x or e.  Returns
// the launch's CUDA error code, 0 when it was accepted.
extern "C" int transfer_prolong_add_f32(const void* x, const void* e,
                                        const void* parent, const void* pw,
                                        void* out, int Cf, int U,
                                        void* stream) {
  return launch_prolong_add<float>(x, e, parent, pw, out, Cf, U, stream);
}

extern "C" int transfer_prolong_add_f64(const void* x, const void* e,
                                        const void* parent, const void* pw,
                                        void* out, int Cf, int U,
                                        void* stream) {
  return launch_prolong_add<double>(x, e, parent, pw, out, Cf, U, stream);
}

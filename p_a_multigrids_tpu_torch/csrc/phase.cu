// K1: one whole block-Jacobi / Chebyshev relaxation phase of the
// semi-structured DG block stencil in one launch, for NVIDIA Hopper
// (sm_90a).
//
// Replaces two TPU kernels of p_a_multigrids_tpu/ops/pallas_stencil.py,
// which each ran a whole phase of R rounds in one pallas_call over a
// (rounds x macro tiles) grid and kept the coefficients in VMEM for it:
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
//   x'_i  = x_i + coef_r * z_i
// reading only the previous round's state (Jacobi semantics: every round
// reads one of two ping-pong buffers and writes the other, and a barrier
// over all blocks separates the rounds).  The last round also writes z when
// it is wanted.  Fp = D^-1 F and Xp = D^-1 X are premultiplied blocks;
// nb_f(c) is the intra-macro neighbor (the child itself on a macro boundary
// face, where Fp is zero); src(s, u) is the cross-macro source of slot s as
// an offset c_src*U + u_src in a (C, U) plane.
//
// Layout: state (3, C, U), Fp (3f, 3i, 3j, C, U), Xp (3i, 3j, nb, U),
// src (nb, U).  A pair is one (c, u), flat index t = c*U + u; block b owns
// the contiguous pairs [b*slice, (b+1)*slice) for the whole phase and its
// threads walk them with a stride of blockDim.x, so coefficient planes and
// state are read coalesced along u.
//
// What bounds it on an H100: bytes, and before this design launches.  A
// phase must move one 3x3 coupling block a face (Fp inside a macro, Xp
// across the strips: 27 floats a pair; a strip face's Fp is zero), x0 and
// bp in and x and z out at least once: 20.4 MB at C = 16, U = 8192 and at
// C = 1, U = 131,072 (6.1 us at 3.35 TB/s) and 15.3 MB at C = 1024, U = 96
// (4.6 us).  The kernel reads the zero Fp blocks too.  The round kernel this
// replaces re-read all of it every round and cost a launch (a ~4.3 us
// device floor and 9-24 us of host time) per round.
//
// What this design does about it.  One launch runs all rounds, and Fp,
// bp and the index offsets of each pair (40 words a pair) stay on chip:
// round 0 reads each block's slice of them from device memory for its own
// arithmetic and keeps it in shared memory, so later rounds read only the
// neighbours' x from the ping-pong buffers, which sit in L2, and the small
// Xp (L2 too), all at addresses known from shared memory, so they are in
// flight together instead of behind a chain of dependent table reads.
// Three tiers, chosen by the host (ops/phase.phase_plan) from the shape and
// the card:
// - small: one block holds the whole level (46 words a pair: C*U <= 1,263
//   pairs on an H100, the sweep's C = 4 at U = 96); the state ping-pongs in
//   its shared memory too and __syncthreads() separates the rounds, so
//   after round 0 nothing but Xp leaves the SM.  (A cluster of up to 8
//   such blocks, reading each other's state as distributed shared memory,
//   lost to the resident tier at 5-6 blocks, C = 4, U = 1,152 and C = 64,
//   U = 96, by 10-35%, and won by 5% at 2 blocks; it is not kept.)
// - resident: one block per SM with its slice on chip (C = 16, U = 8192:
//   159 KB a block; C = 1024, U = 96: 119 KB), a cooperative launch and a
//   grid barrier between rounds;
// - stream: a slice too large for shared memory (C*U = 1,179,648 at
//   n_split 5 on 24 x 24 macros: 189 MB); the same kernel reads Fp, bp and
//   the tables from L2 / device memory every round, with a grid barrier
//   between rounds and as many blocks as the card holds at once.
// A refused launch (a cooperative grid larger than the card holds, too
// much shared memory) returns its CUDA error; the wrapper raises it.
//
// What is left (H100 80GB HBM3, 700 W, utils/profiling.py): a round costs
// 2.6-4.4 us in the resident tier, of which the grid barrier alone takes
// about 1.3 us and the round's L2 reads of x and Xp without the barrier
// 1.7-2.2 us, and 1.7-2.5 us in the small tier, so a 7-round phase takes
// 15-33 us against its 0.02-7.2 us bound: the barriers and the round's
// L2 latency, not the bytes, bound it now.
//
// Scalar type.  Everything above holds in float32 and float64 alike: the
// kernel is a template on its scalar T, instantiated for both, with the
// same tiers, plan and arithmetic order (k1_phase_f32, k1_phase_f64).  A
// pair keeps 30 values of T and 10 int32 words on chip (160 B in float32,
// 280 B in float64) and the small tier 6 more values of T (184 / 328 B),
// so in float64 fewer pairs fit a block: the small tier holds up to 708
// pairs, and C = 16, U = 8192 (993 pairs a block, 278 KB) streams.  A
// double phase moves twice the bytes of a float one.
//
// Memory ordering.  The state written in round r is read by other blocks
// in round r + 1 after the grid barrier (release/acquire semantics); its
// loads bypass L1 (ld.global.cg), so no SM can see a stale line of a
// buffer that another SM rewrote.  The read-only inputs (Fp, bp, Xp,
// tables) are marked __restrict__ const.
//
// Index bounds.  Offsets of a dof plane or coefficient plane (j*C*U + ...)
// are computed in 64 bits, offsets inside a (C, U) plane in 32.  The
// tables are int32: `intra` holds child ids < C, and `src` holds
// c_src*U + u_src < C*U, so the kernel needs C*U < 2^31.  The largest shape the CLI reaches on a generated mesh in
// practice, n_split 5 with --rows 24 --cols 24 (U = 1152), has
// C*U = 1,179,648; the bound is 1,820 times that, and a level at the bound
// would hold 232 GB of Fp, more than the card, so allocating its
// coefficients fails before any launch and the wrapper does not check it.
//
// The checked build (-DPAMG_CHECKED, checked.cuh; `--debug`): every index
// a thread reads from a table is compared with the size it addresses
// (`intra` with C, `slot_ptr` with nb + 1 and a child's slot count with
// kMaxSlots + 1, `slot_idx` with nb, `src` with C*U), and every x and z it
// writes is tested with isfinite.  The first fault goes to the error
// record and a faulty index reads as 0.  In the kept tiers the indices are
// checked in round 0, when they are read from device memory, and later
// rounds read the checked copies on chip.  The rounds' arithmetic and the
// host's launch plan are the unchecked build's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifdef PAMG_CHECKED
#include "checked.cuh"
#endif

namespace cg = cooperative_groups;

namespace {

// rounds one launch takes; ops/phase.py splits a longer phase
constexpr int kMaxRounds = 64;

enum Tier { kSmall = 0, kResident = 1, kStream = 2 };
enum CoefSource { kGlobal, kGlobalKeep, kShared };

template <typename T>
struct Args {
  const T* __restrict__ x0;
  const T* __restrict__ bp;
  const T* __restrict__ Fp;
  const T* __restrict__ Xp;
  const int* __restrict__ intra;
  const int* __restrict__ slot_ptr;
  const int* __restrict__ slot_idx;
  const int* __restrict__ src;
  T* buf0;
  T* buf1;
  T* z_out;
  int C, U, nb, rounds, slice;
  T coef[kMaxRounds];
#ifdef PAMG_CHECKED
  int* record;   // the error record (checked.cuh)
  int site;      // the caller's name for this launch's operator
#endif
};

// What the checked build records as `sub` (utils/debugging.K1_SUBS):
// tables 0-2 intra (face f), 3 slot_ptr, 4 a child's slot count, 5-7
// slot_idx (slot k), 8-10 src (slot k); values 0-2 x (dof i), 3-5 z.
constexpr int kSubSlotPtr = 3, kSubSlotCount = 4, kSubSlotIdx = 5,
              kSubSrc = 8, kSubZ = 3;

// v, an index of pair t read from table `sub`, if it lies in [0, bound);
// in the checked build a fault is recorded and 0 returned otherwise.
template <typename T>
__device__ __forceinline__ int in_range(const Args<T>& a, int v, int bound,
                                        long long t, int sub) {
#ifdef PAMG_CHECKED
  if (v < 0 || v >= bound) {
    pamg_checked::record_fault(a.record, 1, a.site, pamg_checked::kIndex, t,
                               sub, v, bound);
    return 0;
  }
#endif
  return v;
}

// In the checked build, records v, written for pair t as `sub`, unless it
// is finite.  The record keeps the bits of v as a float32 in either
// precision: converting a double Inf or NaN to float keeps it an Inf or a
// NaN, and only those are recorded.
template <typename T>
__device__ __forceinline__ void expect_finite(const Args<T>& a, T v,
                                              long long t, int sub) {
#ifdef PAMG_CHECKED
  if (!isfinite(v))
    pamg_checked::record_fault(a.record, 1, a.site, pamg_checked::kNonFinite,
                               t, sub, __float_as_int(static_cast<float>(v)),
                               0);
#endif
}

// What a pair keeps in shared memory on chip: Fp (27) and bp (3) as
// values of T, then as ints the offsets in a (C, U) plane of its three
// intra-macro neighbors, its number of cross-macro slots and, for each of
// at most kMaxSlots slots, the offsets of its source and of its Xp blocks;
// in the small tier also its state, x of two rounds (6 values of T).
constexpr int kMaxSlots = 3;               // the single child at C = 1
constexpr int kKeepVals = 30;
constexpr int kKeepInts = 4 + 2 * kMaxSlots;

// One round over this block's pairs.  kGlobal reads the coefficients and
// index tables from device memory, kGlobalKeep also keeps them in shared
// memory `keep` ([30][slice] values, then [10][slice] ints), kShared reads
// them from there: then the round's only reads outside shared memory are
// the x and Xp values, all at known addresses, in flight together.
// Outside the small tier x is read from device memory and x_out written
// there (z_out too, unless null).  In the small tier (kBlock: one block
// holds the level, slice = C*U) x is read from device memory in round 0
// (kGlobalKeep) and from shared memory xs_in afterwards (kShared); every
// round writes xs_out, and x_out and z_out in device memory when they are
// not null (the last round).
template <typename T, int kSrc, bool kBlock>
__device__ __forceinline__ void relax_round(const Args<T>& a, const T* x,
                                            T* x_out, T* z_out, T coef,
                                            T* keep, const T* xs_in,
                                            T* xs_out) {
  constexpr bool kFromBlock = kBlock && kSrc == kShared;
  const long long CU = static_cast<long long>(a.C) * a.U;
  const long long nbU = static_cast<long long>(a.nb) * a.U;
  const long long t0 = static_cast<long long>(blockIdx.x) * a.slice;
  const long long rest = CU - t0;
  const int len = rest < a.slice ? static_cast<int>(rest) : a.slice;
  int* ikeep = reinterpret_cast<int*>(keep + kKeepVals * a.slice);
  // dof j of the pair at offset q of a (C, U) plane, previous round
  auto fetch = [&](int j, int q) -> T {
    return kFromBlock ? xs_in[j * a.slice + q] : __ldcg(x + j * CU + q);
  };
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const long long t = t0 + p;
    // the three intra-macro neighbors q, and the source g and Xp offset su
    // of each cross-macro slot (two at a corner child, none inside)
    int q[3], g[kMaxSlots], su[kMaxSlots], ns;
    if (kSrc == kShared) {
#pragma unroll
      for (int f = 0; f < 3; ++f) q[f] = ikeep[f * a.slice + p];
      ns = ikeep[3 * a.slice + p];
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        g[k] = ikeep[(4 + k) * a.slice + p];
        su[k] = ikeep[(4 + kMaxSlots + k) * a.slice + p];
      }
    } else {
      const int c = static_cast<int>(t / a.U);
      const int u = static_cast<int>(t - static_cast<long long>(c) * a.U);
#pragma unroll
      for (int f = 0; f < 3; ++f)
        q[f] = in_range(a, a.intra[f * a.C + c], a.C, t, f) * a.U + u;
      const int k0 = in_range(a, a.slot_ptr[c], a.nb + 1, t, kSubSlotPtr);
      ns = in_range(a, a.slot_ptr[c + 1], a.nb + 1, t, kSubSlotPtr) - k0;
      ns = in_range(a, ns, kMaxSlots + 1, t, kSubSlotCount);
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        if (k < ns) {
          su[k] = in_range(a, a.slot_idx[k0 + k], a.nb, t, kSubSlotIdx + k)
                  * a.U + u;
          g[k] = in_range(a, a.src[su[k]], static_cast<int>(CU), t,
                          kSubSrc + k);
        }
      }
      if (kSrc == kGlobalKeep) {
#pragma unroll
        for (int f = 0; f < 3; ++f) ikeep[f * a.slice + p] = q[f];
        ikeep[3 * a.slice + p] = ns;
#pragma unroll
        for (int k = 0; k < kMaxSlots; ++k) {
          if (k < ns) {
            ikeep[(4 + k) * a.slice + p] = g[k];
            ikeep[(4 + kMaxSlots + k) * a.slice + p] = su[k];
          }
        }
      }
    }

    // intra-macro neighbor values x[j, nb_f(c), u]
    T xn[3][3];
#pragma unroll
    for (int f = 0; f < 3; ++f) {
#pragma unroll
      for (int j = 0; j < 3; ++j) xn[f][j] = fetch(j, q[f]);
    }

    T acc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s = T(0);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int k = (f * 3 + i) * 3 + j;
          T w;
          if (kSrc == kShared) {
            w = keep[k * a.slice + p];
          } else {
            w = a.Fp[k * CU + t];
            if (kSrc == kGlobalKeep) keep[k * a.slice + p] = w;
          }
          s += w * xn[f][j];
        }
      }
      acc[i] = s;
    }

    // cross-macro slots of the child, in slot order
    T cross[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k) {
      if (k < ns) {
        const T s0 = fetch(0, g[k]), s1 = fetch(1, g[k]),
                s2 = fetch(2, g[k]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          cross[i] += a.Xp[(i * 3 + 0) * nbU + su[k]] * s0
                    + a.Xp[(i * 3 + 1) * nbU + su[k]] * s1
                    + a.Xp[(i * 3 + 2) * nbU + su[k]] * s2;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T b;
      if (kSrc == kShared) {
        b = keep[(27 + i) * a.slice + p];
      } else {
        b = a.bp[i * CU + t];
        if (kSrc == kGlobalKeep) keep[(27 + i) * a.slice + p] = b;
      }
      const T xi = fetch(i, static_cast<int>(t));
      const T z = b - xi - (acc[i] + cross[i]);
      const T xo = xi + coef * z;
      expect_finite(a, xo, t, i);
      if (z_out != nullptr) expect_finite(a, z, t, kSubZ + i);
      if (kBlock) xs_out[i * a.slice + p] = xo;
      if (x_out != nullptr) x_out[i * CU + t] = xo;
      if (z_out != nullptr) z_out[i * CU + t] = z;
    }
  }
}

template <typename T, int kTier>
__global__ void __launch_bounds__(1024) phase_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* keep = reinterpret_cast<T*>(smem);
  const int last = a.rounds - 1;
  if constexpr (kTier == kSmall) {
    // the state ping-pongs in shared memory, [2][3][slice] after the kept
    // coefficients and offsets; device memory sees x0 and the last round's
    // x and z only
    T* xs = reinterpret_cast<T*>(
        reinterpret_cast<int*>(keep + kKeepVals * a.slice)
        + kKeepInts * a.slice);
    for (int r = 0; r <= last; ++r) {
      T* x_out = r < last ? nullptr : ((r & 1) ? a.buf1 : a.buf0);
      T* z_out = r < last ? nullptr : a.z_out;
      T* xs_out = xs + (r & 1) * 3 * a.slice;
      if (r == 0) {
        relax_round<T, kGlobalKeep, true>(a, a.x0, x_out, z_out, a.coef[r],
                                          keep, nullptr, xs_out);
      } else {
        relax_round<T, kShared, true>(a, nullptr, x_out, z_out, a.coef[r],
                                      keep, xs + ((r - 1) & 1) * 3 * a.slice,
                                      xs_out);
      }
      __syncthreads();
    }
    return;
  }
  for (int r = 0; r <= last; ++r) {
    const T* x = r == 0 ? a.x0 : ((r & 1) ? a.buf0 : a.buf1);
    T* x_out = (r & 1) ? a.buf1 : a.buf0;
    T* z_out = r == last ? a.z_out : nullptr;
    if constexpr (kTier == kStream) {
      relax_round<T, kGlobal, false>(a, x, x_out, z_out, a.coef[r], keep,
                                     nullptr, nullptr);
    } else if (r == 0) {
      relax_round<T, kGlobalKeep, false>(a, x, x_out, z_out, a.coef[r], keep,
                                         nullptr, nullptr);
    } else {
      relax_round<T, kShared, false>(a, x, x_out, z_out, a.coef[r], keep,
                                     nullptr, nullptr);
    }
    if (r < last) cg::this_grid().sync();
  }
}

// Allow up to the card's opt-in shared memory per block, once per kernel.
template <typename T, int kTier>
cudaError_t allow_shared_memory() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    int dev = 0, optin = 0;
    done = cudaGetDevice(&dev);
    if (done == cudaSuccess)
      done = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(
          phase_kernel<T, kTier>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin);
  }
  return done;
}

template <typename T>
int launch_phase(const void* x0, const void* bp, const void* Fp,
                 const void* Xp, const void* intra, const void* slot_ptr,
                 const void* slot_idx, const void* src, void* buf0,
                 void* buf1, void* z_out, const T* coefs, int rounds, int C,
                 int U, int nb, int tier, int grid, int threads, int slice,
                 int smem, void* stream, void* record, int site) {
  if (rounds < 1 || rounds > kMaxRounds || grid < 1 || threads < 1
      || (tier == kSmall && grid != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.x0 = static_cast<const T*>(x0);
  a.bp = static_cast<const T*>(bp);
  a.Fp = static_cast<const T*>(Fp);
  a.Xp = static_cast<const T*>(Xp);
  a.intra = static_cast<const int*>(intra);
  a.slot_ptr = static_cast<const int*>(slot_ptr);
  a.slot_idx = static_cast<const int*>(slot_idx);
  a.src = static_cast<const int*>(src);
  a.buf0 = static_cast<T*>(buf0);
  a.buf1 = static_cast<T*>(buf1);
  a.z_out = static_cast<T*>(z_out);
  a.C = C;
  a.U = U;
  a.nb = nb;
  a.rounds = rounds;
  a.slice = slice;
  for (int r = 0; r < rounds; ++r) a.coef[r] = coefs[r];
#ifdef PAMG_CHECKED
  if (record == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.record = static_cast<int*>(record);
  a.site = site;
#else
  (void)record;
  (void)site;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* params[] = {&a};
  cudaError_t err;
  if (tier == kSmall) {
    err = allow_shared_memory<T, kSmall>();
    if (err != cudaSuccess) return static_cast<int>(err);
    phase_kernel<T, kSmall><<<grid, threads, smem, s>>>(a);
    err = cudaSuccess;
  } else if (tier == kResident) {
    err = allow_shared_memory<T, kResident>();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(phase_kernel<T, kResident>), dim3(grid),
        dim3(threads), params, smem, s);
  } else if (tier == kStream) {
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(phase_kernel<T, kStream>), dim3(grid),
        dim3(threads), params, 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The card's numbers the host plan needs for state of `itemsize` bytes (4:
// float32, 8: float64): SMs, opt-in shared memory per block, and how many
// 1024-thread blocks of that type's streaming tier an SM holds at once.
// Returns a CUDA error code, 0 on success.
extern "C" int k1_phase_limits(int itemsize, int* sm_count, int* smem_optin,
                               int* stream_blocks_per_sm) {
  if (itemsize != 4 && itemsize != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = itemsize == 4
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              stream_blocks_per_sm, phase_kernel<float, kStream>, 1024, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              stream_blocks_per_sm, phase_kernel<double, kStream>, 1024, 0);
  return static_cast<int>(err);
}

// One phase of `rounds` rounds (1..64) with step sizes coefs[0..rounds) on
// `stream`, in the tier and launch shape the host planned: `grid` blocks of
// `threads`, `slice` pairs a block, `smem` bytes of dynamic shared memory
// ((36 * itemsize + 40) * slice small, (30 * itemsize + 40) * slice
// resident, 0 streaming).  Round r reads x0 (r = 0) or the buffer round
// r - 1 wrote and writes buf0 (r even) or buf1 (r odd); the last round also
// writes z_out unless it is null.  Every array and coefs are float32
// (k1_phase_f32) or float64 (k1_phase_f64); the index tables int32.  The
// checked build records its first fault in `record` (checked.cuh) as
// operator `site`; the unchecked build ignores both.  Returns the launch's
// CUDA error code, 0 when it was accepted.
extern "C" int k1_phase_f32(const void* x0, const void* bp, const void* Fp,
                            const void* Xp, const void* intra,
                            const void* slot_ptr, const void* slot_idx,
                            const void* src, void* buf0, void* buf1,
                            void* z_out, const float* coefs, int rounds,
                            int C, int U, int nb, int tier, int grid,
                            int threads, int slice, int smem, void* stream,
                            void* record, int site) {
  return launch_phase<float>(x0, bp, Fp, Xp, intra, slot_ptr, slot_idx, src,
                             buf0, buf1, z_out, coefs, rounds, C, U, nb,
                             tier, grid, threads, slice, smem, stream,
                             record, site);
}

extern "C" int k1_phase_f64(const void* x0, const void* bp, const void* Fp,
                            const void* Xp, const void* intra,
                            const void* slot_ptr, const void* slot_idx,
                            const void* src, void* buf0, void* buf1,
                            void* z_out, const double* coefs, int rounds,
                            int C, int U, int nb, int tier, int grid,
                            int threads, int slice, int smem, void* stream,
                            void* record, int site) {
  return launch_phase<double>(x0, bp, Fp, Xp, intra, slot_ptr, slot_idx,
                              src, buf0, buf1, z_out, coefs, rounds, C, U,
                              nb, tier, grid, threads, slice, smem, stream,
                              record, site);
}

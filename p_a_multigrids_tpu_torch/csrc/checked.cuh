// The error record of the checked builds of kernels K1 (phase.cu) and K2
// (spmv.cu), compiled with -DPAMG_CHECKED (utils/cuda_build.load's
// `defines`; the CHECKED instances of ops/phase.py and ops/spmv.py).
//
// The counterpart on the card of the JAX package's sanitizer, which ran
// the step under jax.experimental.checkify with index checks on every
// gather and float checks on NaN/Inf generation.  A checked kernel compares
// every index it reads from a table with the size of what it addresses,
// and tests every value it writes with isfinite.  The first fault of a
// run is recorded in a small int32 record in device memory, which the host
// allocates zeroed, passes to every checked launch of a step and reads once
// after the step (utils/debugging.Sanitizer, which raises IndexError or
// FloatingPointError from it).  A faulty index is replaced by 0, an index
// every table has, so the launch never reads outside its tables and the
// card stays usable for the error to be read.  Nothing else changes: the
// arithmetic, its order and the launch plan are those of the unchecked
// build, so a clean checked run gives the same bits.

#pragma once

#include <cuda_runtime.h>

namespace pamg_checked {

// fields of the record (utils/debugging.RECORD_FIELDS)
enum Field { kFlag, kKernel, kKind, kSite, kPos, kSub, kValue, kBound };
enum Kind { kIndex = 1, kNonFinite = 2 };

// Record a fault unless one is recorded already: the thread that turns the
// flag from 0 to 1 writes the rest.  `pos` is the kernel's position (a
// (child, macro) pair t = c*U + u for K1, a row for K2), `sub` which table
// or dof, `value` the offending index or the float's bits, `bound` the size
// the index addresses.
__device__ __forceinline__ void record_fault(int* rec, int kernel, int site,
                                             int kind, long long pos,
                                             int sub, int value, int bound) {
  if (*reinterpret_cast<volatile int*>(rec) != 0) return;
  if (atomicCAS(rec, 0, 1) != 0) return;
  rec[kKernel] = kernel;
  rec[kKind] = kind;
  rec[kSite] = site;
  rec[kPos] = static_cast<int>(pos);
  rec[kSub] = sub;
  rec[kValue] = value;
  rec[kBound] = bound;
}

}  // namespace pamg_checked

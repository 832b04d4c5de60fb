// Device code shared by the order-parameter kernels (p2.cu, ua.cu): the
// minimum image, the reference's fixed-point sample, and the per-block
// (2, T) int64 table of per-type [sum, count] that a block fills with
// shared-memory atomics and adds to the output with one global atomic per
// nonzero entry.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gorder {

constexpr int kSharedTypes = 3072;  // 2 * T * 8 bytes <= 48 KiB

// d - L*rint(d/L): rint rounds half to even, like jnp.round/torch.round.
__device__ __forceinline__ float min_image(float d, float box) {
  return __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
}

// The reference's fixed-point sample llround(f64(S) * 1e6)
// (src/analysis/order.rs:21-26): the f64 product of an f32 is exact, and
// llround rounds half away from zero.
__device__ __forceinline__ long long quantum(float sch) {
  return llround(__dmul_rn(static_cast<double>(sch), 1.0e6));
}

// A block's table of per-type [sum, count] for its frame: (2, T) in
// shared memory when kShared, else the frame's rows of the output.
template <bool kShared>
struct TypeTable {
  unsigned long long* acc;
  unsigned long long* frame_out;
  int n_types;

  // Every thread of the block calls this (it synchronizes when kShared).
  __device__ __forceinline__ TypeTable(unsigned long long* smem,
                                       unsigned long long* out, int b,
                                       int types)
      : acc(kShared ? smem : out + static_cast<size_t>(b) * 2 * types),
        frame_out(out + static_cast<size_t>(b) * 2 * types),
        n_types(types) {
    if constexpr (kShared) {
      for (int k = threadIdx.x; k < 2 * n_types; k += blockDim.x) acc[k] = 0;
      __syncthreads();
    }
  }

  __device__ __forceinline__ void add(int t, long long q) const {
    atomicAdd(acc + t, static_cast<unsigned long long>(q));
    atomicAdd(acc + n_types + t, 1ULL);
  }

  // Every thread of the block calls this once, after its last add.
  __device__ __forceinline__ void flush() const {
    if constexpr (kShared) {
      __syncthreads();
      for (int k = threadIdx.x; k < 2 * n_types; k += blockDim.x) {
        if (acc[k] != 0ULL) atomicAdd(frame_out + k, acc[k]);
      }
    }
  }
};

// Shared-memory bytes of a kShared table of n_types.
inline size_t table_bytes(int n_types) {
  return 2 * static_cast<size_t>(n_types) * sizeof(unsigned long long);
}

}  // namespace gorder

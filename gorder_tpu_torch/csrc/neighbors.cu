// Dense neighbour passes for Hopper (sm_90a): the masked reductions over
// every (head, neighbour) pair of a frame that dynamic membrane normals and
// the local leaflet classifier take.
//
// Neither replaces a Pallas kernel: gorder_tpu computes both with XLA ops,
// gorder_tpu/core/normals.py `_dynamic_normals_impl` (:34-55) and
// gorder_tpu/core/leaflets.py `_local_classify_impl` (:107-141), and the
// port's plain versions (gorder_tpu_torch/ops/neighbors.py) copy them op by
// op over (F, M, C) intermediates in device memory.
//
// normal_cloud: per frame b and head m, over the cloud atoms c, the offset
// rel = x[c] - x[head] with the minimum image d - L*rint(d/L) per component
// (rint: half to even, as torch.round), d2 = rel0*rel0 + rel1*rel1 +
// rel2*rel2 left to right, the mask d2 <= f32(r)*f32(r), the count, the
// weight w = 1 / max(count, 1), the centroid sum(w * rel), and the masked
// centred covariance sum((rel - centroid) (x) (rel - centroid)) over the
// masked atoms: counts (B, M) f32 and the six entries xx xy xz yy yz zz of
// the covariance (B, M, 6) f32. Every f32 step is an _rn intrinsic, so d2
// and the mask are the plain version's bit for bit and the counts equal
// it. The sums run in f64, in the order of the cloud, and are rounded to
// f32 once: torch's .sum adds in f32 in another order, so the centroid and
// the covariance agree with the plain version to a few f32 ulps, not bit
// for bit. The centroid is f32(w * sum(rel)) with the sum in f64, which is
// sum(w * rel) up to that one rounding. Two passes over the cloud, as the
// plain version's centroid and then centred covariance: the first counts
// and sums rel, the second adds the centred products.
//
// local_sums: per frame b and head m, over the membrane atoms j, the
// in-plane offset d_a = p_a[j] - h_a for the two plane axes (each
// min-imaged under PBC), the weight w = d0*d0 + d1*d1 <= f32(r)*f32(r), and
// (sum w*v0[j], sum w*v1[j]) (B, M, 2) f32, in f64 and rounded once. The
// caller packs each membrane atom as (p0, p1, v0, v1): with PBC v = (cos
// theta, sin theta) of its position along the normal, for the circular
// mean; without, v = (z, 1), the plain mean and the count.
//
// What bounds them on this card: operations. A pair costs about 21 f32
// operations (three correctly rounded divisions of the minimum image, each
// several instructions, then d2 and the test) against 12 bytes of the
// cloud that a frame reads once, so the pairs, M x C a frame (44 M for the
// 6,650-head vesicle, 8.8 M for 256 heads over 34,304 membrane atoms),
// and not the bytes, set the time. What the design does about it:
//   - no pair is ever written to device memory: the plain versions write
//     and read back several (F, M, C) f32 intermediates, 177 MB a pass for
//     one vesicle frame;
//   - one thread a head, a block 256 heads of one frame, grid (head tiles,
//     frames): the neighbours go through shared memory in tiles that every
//     thread of the block reads as a broadcast; normal_cloud keeps a cloud
//     of up to `tile` atoms resident for both passes and loads larger
//     clouds tile by tile in each pass. The wrapper's tile is 2,048 atoms
//     (24 KB): on an H100 a vesicle batch's 6,650 heads took 124 ms so,
//     against 147 ms resident whole (79.8 KB, past the default 48 KB,
//     which the kernel opts in to), since smaller tiles let more blocks
//     share a SM (gorder_tpu_torch/diagnostics/neighbors.py);
//   - only masked pairs reach the f64 adds (a few percent of the vesicle's
//     pairs, about an eighth of the membrane's), so accumulating in f64
//     costs little beside the distance test.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// A tile may take up to the card's 227 KiB of shared memory a block.
constexpr size_t kMaxShared = 227 * 1024;

struct CloudArgs {
  const float* coords;    // (B, A, 3)
  const float* box;       // (B, 3)
  const int64_t* heads;   // (M,)
  const int64_t* cloud;   // (C,)
  float* counts;          // (B, M)
  float* cov;             // (B, M, 6)
  int n_atoms, n_heads, n_cloud, tile;
  float r2;
};

// The min-imaged offset q - p of one component (plain: d - L*round(d/L)).
template <bool kPbc>
__device__ __forceinline__ float offset(float q, float p, float box) {
  const float d = __fsub_rn(q, p);
  return kPbc ? gorder::min_image(d, box) : d;
}

// Load atoms [start, start + n) of `idx` of frame `x` into the block's
// shared x, y, z rows of `tile` floats each.
__device__ __forceinline__ void load_cloud(float* sm, const float* x,
                                           const int64_t* idx, int start,
                                           int n, int tile) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* p = x + 3 * idx[start + k];
    sm[k] = p[0];
    sm[tile + k] = p[1];
    sm[2 * tile + k] = p[2];
  }
}

template <bool kPbc>
__global__ void __launch_bounds__(kThreads)
    normal_cloud_kernel(CloudArgs a) {
  extern __shared__ float sm[];
  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool active = m < a.n_heads;
  const float* x = a.coords + static_cast<size_t>(b) * a.n_atoms * 3;
  const float3 L = make_float3(a.box[3 * b], a.box[3 * b + 1],
                               a.box[3 * b + 2]);
  float3 h = make_float3(0.0f, 0.0f, 0.0f);
  if (active) {
    const float* p = x + 3 * a.heads[m];
    h = make_float3(p[0], p[1], p[2]);
  }
  const float* sx = sm;
  const float* sy = sm + a.tile;
  const float* sz = sm + 2 * a.tile;
  const bool resident = a.n_cloud <= a.tile;

  // pass 1: the count and the f64 sum of the masked offsets
  int count = 0;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int start = 0; start < a.n_cloud; start += a.tile) {
    const int n = min(a.tile, a.n_cloud - start);
    __syncthreads();
    load_cloud(sm, x, a.cloud, start, n, a.tile);
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < n; ++c) {
      const float o0 = offset<kPbc>(sx[c], h.x, L.x);
      const float o1 = offset<kPbc>(sy[c], h.y, L.y);
      const float o2 = offset<kPbc>(sz[c], h.z, L.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(o0, o0),
                                           __fmul_rn(o1, o1)),
                                 __fmul_rn(o2, o2));
      if (d2 <= a.r2) {
        ++count;
        s0 += o0;
        s1 += o1;
        s2 += o2;
      }
    }
  }
  const float w = __fdiv_rn(1.0f, fmaxf(static_cast<float>(count), 1.0f));
  const float c0 = static_cast<float>(s0 * w);
  const float c1 = static_cast<float>(s1 * w);
  const float c2 = static_cast<float>(s2 * w);

  // pass 2: the f64 sums of the centred products of the masked offsets
  double xx = 0.0, xy = 0.0, xz = 0.0, yy = 0.0, yz = 0.0, zz = 0.0;
  for (int start = 0; start < a.n_cloud; start += a.tile) {
    const int n = min(a.tile, a.n_cloud - start);
    if (!resident) {
      __syncthreads();
      load_cloud(sm, x, a.cloud, start, n, a.tile);
      __syncthreads();
    }
    if (!active) continue;
    for (int c = 0; c < n; ++c) {
      const float o0 = offset<kPbc>(sx[c], h.x, L.x);
      const float o1 = offset<kPbc>(sy[c], h.y, L.y);
      const float o2 = offset<kPbc>(sz[c], h.z, L.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(o0, o0),
                                           __fmul_rn(o1, o1)),
                                 __fmul_rn(o2, o2));
      if (d2 <= a.r2) {
        const float e0 = __fsub_rn(o0, c0);
        const float e1 = __fsub_rn(o1, c1);
        const float e2 = __fsub_rn(o2, c2);
        xx += __fmul_rn(e0, e0);
        xy += __fmul_rn(e0, e1);
        xz += __fmul_rn(e0, e2);
        yy += __fmul_rn(e1, e1);
        yz += __fmul_rn(e1, e2);
        zz += __fmul_rn(e2, e2);
      }
    }
  }
  if (!active) return;
  const size_t row = static_cast<size_t>(b) * a.n_heads + m;
  a.counts[row] = static_cast<float>(count);
  float* out = a.cov + 6 * row;
  out[0] = static_cast<float>(xx);
  out[1] = static_cast<float>(xy);
  out[2] = static_cast<float>(xz);
  out[3] = static_cast<float>(yy);
  out[4] = static_cast<float>(yz);
  out[5] = static_cast<float>(zz);
}

struct LocalArgs {
  const float4* members;  // (B, Nm, 4): p0, p1, v0, v1
  const float2* heads;    // (B, M, 2): the heads' plane components
  const float2* box;      // (B, 2): the plane lengths (PBC only)
  float2* out;            // (B, M, 2)
  int n_members, n_heads, tile;
  float r2;
};

template <bool kPbc>
__global__ void __launch_bounds__(kThreads) local_sums_kernel(LocalArgs a) {
  extern __shared__ float4 tile[];
  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool active = m < a.n_heads;
  const float4* members = a.members + static_cast<size_t>(b) * a.n_members;
  const float2 L = kPbc ? a.box[b] : make_float2(1.0f, 1.0f);
  const float2 h = active ? a.heads[static_cast<size_t>(b) * a.n_heads + m]
                          : make_float2(0.0f, 0.0f);
  double s0 = 0.0, s1 = 0.0;
  for (int start = 0; start < a.n_members; start += a.tile) {
    const int n = min(a.tile, a.n_members - start);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kThreads)
      tile[k] = members[start + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float d0 = offset<kPbc>(p.x, h.x, L.x);
      const float d1 = offset<kPbc>(p.y, h.y, L.y);
      if (__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)) <= a.r2) {
        s0 += p.z;
        s1 += p.w;
      }
    }
  }
  if (active)
    a.out[static_cast<size_t>(b) * a.n_heads + m] =
        make_float2(static_cast<float>(s0), static_cast<float>(s1));
}

// A launch over (head tiles, frames) with `bytes` of dynamic shared memory.
template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, const Args& a, int n_frames, size_t bytes,
                   cudaStream_t stream) {
  cudaError_t err = gorder::allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_heads + kThreads - 1) / kThreads, n_frames);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream` and returns the first
// error (0 = launched); the outputs are written whole. n_frames <= 65535;
// 0 < tile and the tile's shared memory (12 bytes an atom for
// normal_cloud, 16 for local_sums) at most 227 KiB.

// coords (B, A, 3) f32, box (B, 3) f32, heads (M,) and cloud (C,) int64
// atom indices < A → counts (B, M) f32 and cov (B, M, 6) f32; r2 =
// f32(r)*f32(r).
int normal_cloud(const void* coords, const void* box, const void* heads,
                 const void* cloud, void* counts, void* cov, int n_frames,
                 int n_atoms, int n_heads, int n_cloud, float r2, int pbc,
                 int tile, void* stream) {
  const size_t bytes = 3 * sizeof(float) * static_cast<size_t>(tile);
  if (n_frames < 0 || n_frames > 65535 || n_heads < 0 || n_cloud < 0 ||
      tile <= 0 || bytes > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n_heads == 0) return 0;
  const CloudArgs a{static_cast<const float*>(coords),
                    static_cast<const float*>(box),
                    static_cast<const int64_t*>(heads),
                    static_cast<const int64_t*>(cloud),
                    static_cast<float*>(counts),
                    static_cast<float*>(cov),
                    n_atoms,
                    n_heads,
                    n_cloud,
                    tile,
                    r2};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      pbc ? launch(normal_cloud_kernel<true>, a, n_frames, bytes, s)
          : launch(normal_cloud_kernel<false>, a, n_frames, bytes, s));
}

// members (B, Nm, 4) f32, heads (B, M, 2) f32, box (B, 2) f32 (read with
// pbc only) → out (B, M, 2) f32; r2 = f32(r)*f32(r).
int local_sums(const void* members, const void* heads, const void* box,
               void* out, int n_frames, int n_members, int n_heads, float r2,
               int pbc, int tile, void* stream) {
  const size_t bytes = sizeof(float4) * static_cast<size_t>(tile);
  if (n_frames < 0 || n_frames > 65535 || n_heads < 0 || n_members < 0 ||
      tile <= 0 || bytes > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n_heads == 0) return 0;
  const LocalArgs a{static_cast<const float4*>(members),
                    static_cast<const float2*>(heads),
                    static_cast<const float2*>(box),
                    static_cast<float2*>(out),
                    n_members,
                    n_heads,
                    tile,
                    r2};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      pbc ? launch(local_sums_kernel<true>, a, n_frames, bytes, s)
          : launch(local_sums_kernel<false>, a, n_frames, bytes, s));
}

}  // extern "C"

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
// rel2*rel2 left to right, the mask d2 <= f32(r)*f32(r), the count and the
// masked centred covariance sum((rel - centroid) (x) (rel - centroid)):
// counts (B, M) f32 and the six entries xx xy xz yy yz zz of the
// covariance (B, M, 6) f32. Every f32 step of the offset and the test is
// the plain version's, so d2 and the mask are its own bit for bit and the
// counts equal it. One pass over the cloud: a masked atom adds its offset
// to three f64 sums and the six products of its components, exact in f64,
// to six more; at the end sum(o_a o_b) - sum(o_a) sum(o_b) / n in f64,
// rounded to f32 once. The masked offsets lie within the radius, so the
// f64 difference keeps every bit that the plain version's f32 centred sums
// keep; those add in f32 in torch's order, so the two agree to a few f32
// ulps of the magnitudes summed, not bit for bit. The caller gathers the
// heads' and the cloud's coordinates, (B, M, 3) and (B, C, 3), so that a
// block reads its tiles of the cloud contiguously.
//
// local_sums: per frame b and head m, over the membrane atoms j, the
// in-plane offset d_a = p_a[j] - h_a for the two plane axes (each
// min-imaged under PBC), the weight w = d0*d0 + d1*d1 <= f32(r)*f32(r), and
// (sum w*v0[j], sum w*v1[j]) (B, M, 2) f32, in f64 and rounded once. The
// caller packs each membrane atom as (p0, p1, v0, v1): with PBC v = (cos
// theta, sin theta) of its position along the normal, for the circular
// mean; without, v = (z, 1), the plain mean and the count.
//
// What bounds them on this card: dispatching f32 instructions. A pair is
// some 20 f32 operations (chip_smoke.py CLOUD_PAIR_OPS, LOCAL_PAIR_OPS)
// against 12 or 16 bytes of a neighbour that a block reads once for many
// heads, so the pairs, M x C a frame (44 M for the 6,650-head vesicle,
// 7.7 M for 256 heads over 30,208 membrane atoms), set the time. None of
// the chain may fuse into an FMA (the plain version rounds every step), so
// a pair takes one instruction an operation at least. What the design does
// about it:
//   - no pair is ever written to device memory: the plain versions write
//     and read back several (F, M, C) f32 intermediates;
//   - the minimum image takes no division and no conversion unit in the
//     common case (`min_image_fast`, common.cuh): t = d * fl(1/L), 1/L once a
//     block's frame, rint(t) on the f32 pipe (two adds, where rintf is a
//     conversion), and the correctly rounded division of common.cuh only
//     for a pair whose t lies within the margin of a tie, where rint(t)
//     could differ from rint(fl(d/L)); the rest is common.cuh's d - L*k,
//     so the offset is the plain one. A tile whose
//     coordinates or heads leave [-L, 2L] takes the division for every
//     pair (one check a tile, `in_range`), so that no pair need test |t|;
//   - each thread holds one head in registers with its sums, and reads
//     each neighbour from shared memory with one 8- or 16-byte broadcast
//     load;
//   - a block is kGroups warps, each over every kGroups-th neighbour of the
//     same shared tile for the same 32 heads, so that a frame with few
//     heads still gives the card enough blocks (256 heads a frame: 8 blocks
//     of 256 threads, 3.9 times the card's 270,336 thread slots for 512
//     frames). The warps' sums meet in shared memory in warp order, so the
//     same inputs give the same bits on every launch; no floating-point
//     atomics;
//   - only masked pairs reach the f64 adds (a few percent of the vesicle's
//     pairs, about an eighth of the membrane's); local_sums converts its
//     values to f64 once as a block loads them, not once a pair.
// On an H100 80GB HBM3 at 700 W (PERF.md §6) the division-free minimum
// image took the two-pass kernel from 124 to 95 ms on a vesicle batch; the
// one pass and the warps over the tile to 32 ms. Four heads a thread (the
// neighbour's load and the loop paid once for four pairs) ran the vesicle
// within the run-to-run spread of one and the 256-head batches 11-18 %
// slower, so a thread takes one.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// The warps of a block: warp g takes atoms g, g + kGroups, ... of a tile.
constexpr int kGroups = kThreads / 32;
// The blocks of normal_cloud that a SM should hold, which caps a thread's
// registers at 65,536 / (kThreads * kCloudBlocks) = 64 (uncapped, the AA
// batch ran some 15 % slower on an H100).
constexpr int kCloudBlocks = 4;
// A block may take up to the card's 227 KiB of shared memory.
constexpr size_t kMaxShared = 227 * 1024;
// The division-free minimum image and its guards (common.cuh).
using gorder::in_range;
using gorder::kMinMargin;
using gorder::min_image_fast;
using gorder::offset;

// One head's sums over its masked cloud atoms: the count, the f64 sums of
// the offsets, and of their products xx xy xz yy yz zz (exact in f64).
struct CloudSums {
  int n;
  double s[3];
  double p[6];

  __device__ __forceinline__ void add(float o0, float o1, float o2) {
    const double e0 = o0, e1 = o1, e2 = o2;
    ++n;
    s[0] += e0;
    s[1] += e1;
    s[2] += e2;
    // the products of two f32 values are exact in f64, so each fma rounds
    // once, as the add alone would
    p[0] = __fma_rn(e0, e0, p[0]);
    p[1] = __fma_rn(e0, e1, p[1]);
    p[2] = __fma_rn(e0, e2, p[2]);
    p[3] = __fma_rn(e1, e1, p[3]);
    p[4] = __fma_rn(e1, e2, p[4]);
    p[5] = __fma_rn(e2, e2, p[5]);
  }

  __device__ __forceinline__ void add(const CloudSums& o) {
    n += o.n;
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] += o.s[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) p[k] += o.p[k];
  }
};

struct CloudArgs {
  const float* heads;  // (B, M, 3)
  const float* cloud;  // (B, C, 3)
  const float* box;    // (B, 3)
  float* counts;       // (B, M)
  float* cov;          // (B, M, 6)
  int n_heads, n_cloud, tile;
  float r2, margin;
};

// One warp's pairs of a tile of the cloud (`at` .. `end`, every
// kGroups-th atom) with the thread's head: kFast takes min_image_fast,
// which the tile's coordinates in range allow, and the division where the
// pair is at a tie; else the division for every pair.
template <bool kPbc, bool kFast>
__device__ __forceinline__ void cloud_tile(const float4* at,
                                           const float4* end, float3 h,
                                           float3 L, float3 inv, float edge,
                                           float r2, CloudSums& acc) {
  for (; at < end; at += kGroups) {
    const float4 q = *at;
    float3 o;
    bool tie = !kFast;
    if (kFast)
      o = make_float3(min_image_fast<kPbc>(q.x, h.x, L.x, inv.x, edge, tie),
                      min_image_fast<kPbc>(q.y, h.y, L.y, inv.y, edge, tie),
                      min_image_fast<kPbc>(q.z, h.z, L.z, inv.z, edge, tie));
    if (__builtin_expect(tie, 0))
      o = make_float3(offset<kPbc>(q.x, h.x, L.x),
                      offset<kPbc>(q.y, h.y, L.y),
                      offset<kPbc>(q.z, h.z, L.z));
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(o.x, o.x),
                                         __fmul_rn(o.y, o.y)),
                               __fmul_rn(o.z, o.z));
    if (d2 <= r2) acc.add(o.x, o.y, o.z);
  }
}

template <bool kPbc>
__global__ void __launch_bounds__(kThreads, kCloudBlocks)
    normal_cloud_kernel(CloudArgs a) {
  extern __shared__ float4 sm[];
  const int lane = threadIdx.x % 32;
  const int group = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int m = blockIdx.x * 32 + lane;
  const float* cloud = a.cloud + static_cast<size_t>(b) * a.n_cloud * 3;
  const float3 L = make_float3(a.box[3 * b], a.box[3 * b + 1],
                               a.box[3 * b + 2]);
  const float3 inv = make_float3(__frcp_rn(L.x), __frcp_rn(L.y),
                                 __frcp_rn(L.z));
  const float edge = gorder::tie_edge(a.margin);
  // the head's row; a lane past the last head takes the last, writes none
  const size_t row = static_cast<size_t>(b) * a.n_heads + min(m, a.n_heads - 1);
  const float* hp = a.heads + 3 * row;
  const float3 h = make_float3(hp[0], hp[1], hp[2]);
  const bool head_in = in_range(h.x, L.x) & in_range(h.y, L.y) &
                       in_range(h.z, L.z);
  CloudSums acc{};

  for (int start = 0; start < a.n_cloud; start += a.tile) {
    const int n = min(a.tile, a.n_cloud - start);
    __syncthreads();
    bool in = head_in;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float* p = cloud + 3 * static_cast<size_t>(start + k);
      const float4 q = make_float4(p[0], p[1], p[2], 0.0f);
      in &= in_range(q.x, L.x) & in_range(q.y, L.y) & in_range(q.z, L.z);
      sm[k] = q;
    }
    // the block's heads and the tile's atoms in range, or not
    const bool fast = __syncthreads_and(in) || !kPbc;
    if (fast)
      cloud_tile<kPbc, true>(sm + group, sm + n, h, L, inv, edge, a.r2, acc);
    else
      cloud_tile<kPbc, false>(sm + group, sm + n, h, L, inv, edge, a.r2,
                              acc);
  }

  // the warps' sums meet in shared memory, added in warp order
  CloudSums* part = reinterpret_cast<CloudSums*>(sm);
  __syncthreads();
  if (group > 0) part[(group - 1) * 32 + lane] = acc;
  __syncthreads();
  if (group > 0 || m >= a.n_heads) return;
  for (int g = 1; g < kGroups; ++g) acc.add(part[(g - 1) * 32 + lane]);
  a.counts[row] = static_cast<float>(acc.n);
  // sum((o_a - mean_a)(o_b - mean_b)) = sum(o_a o_b) - sum(o_a) mean_b
  const double w = 1.0 / (acc.n > 0 ? acc.n : 1);
  const double mean[3] = {acc.s[0] * w, acc.s[1] * w, acc.s[2] * w};
  float* out = a.cov + 6 * row;
  out[0] = static_cast<float>(acc.p[0] - acc.s[0] * mean[0]);
  out[1] = static_cast<float>(acc.p[1] - acc.s[0] * mean[1]);
  out[2] = static_cast<float>(acc.p[2] - acc.s[0] * mean[2]);
  out[3] = static_cast<float>(acc.p[3] - acc.s[1] * mean[1]);
  out[4] = static_cast<float>(acc.p[4] - acc.s[1] * mean[2]);
  out[5] = static_cast<float>(acc.p[5] - acc.s[2] * mean[2]);
}

struct LocalArgs {
  const float4* members;  // (B, Nm, 4): p0, p1, v0, v1
  const float2* heads;    // (B, M, 2): the heads' plane components
  const float2* box;      // (B, 2): the plane lengths (PBC only)
  float2* out;            // (B, M, 2)
  int n_members, n_heads, tile;
  float r2, margin;
};

// One warp's pairs of a tile of the membrane (every kGroups-th atom of
// [c, n)) with the thread's head, the masked values added to `acc`: kFast
// takes min_image_fast and the division where the pair is at a tie; else
// the division for every pair. An atom's values are read only where the
// head takes it.
template <bool kPbc, bool kFast>
__device__ __forceinline__ void local_tile(const float2* plane,
                                           const double2* values, int c,
                                           int n, float2 h, float2 L,
                                           float2 inv, float edge, float r2,
                                           double2& acc) {
  for (; c < n; c += kGroups) {
    const float2 q = plane[c];
    float2 d;
    bool tie = !kFast;
    if (kFast)
      d = make_float2(min_image_fast<kPbc>(q.x, h.x, L.x, inv.x, edge, tie),
                      min_image_fast<kPbc>(q.y, h.y, L.y, inv.y, edge, tie));
    if (__builtin_expect(tie, 0))
      d = make_float2(offset<kPbc>(q.x, h.x, L.x),
                      offset<kPbc>(q.y, h.y, L.y));
    if (__fadd_rn(__fmul_rn(d.x, d.x), __fmul_rn(d.y, d.y)) <= r2) {
      const double2 v = values[c];
      acc.x += v.x;
      acc.y += v.y;
    }
  }
}

template <bool kPbc>
__global__ void __launch_bounds__(kThreads) local_sums_kernel(LocalArgs a) {
  // a tile of the membrane: its values in f64, then its plane positions
  extern __shared__ double2 values[];
  float2* plane = reinterpret_cast<float2*>(values + a.tile);
  const int lane = threadIdx.x % 32;
  const int group = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int m = blockIdx.x * 32 + lane;
  const float4* members = a.members + static_cast<size_t>(b) * a.n_members;
  const float2 L = kPbc ? a.box[b] : make_float2(1.0f, 1.0f);
  const float2 inv = make_float2(__frcp_rn(L.x), __frcp_rn(L.y));
  const float edge = gorder::tie_edge(a.margin);
  const float2 h =
      a.heads[static_cast<size_t>(b) * a.n_heads + (m < a.n_heads ? m : 0)];
  const bool head_in = in_range(h.x, L.x) & in_range(h.y, L.y);
  double2 acc = make_double2(0.0, 0.0);

  for (int start = 0; start < a.n_members; start += a.tile) {
    const int n = min(a.tile, a.n_members - start);
    __syncthreads();
    bool in = head_in;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float4 p = members[start + k];
      in &= in_range(p.x, L.x) & in_range(p.y, L.y);
      plane[k] = make_float2(p.x, p.y);
      values[k] = make_double2(p.z, p.w);
    }
    const bool fast = __syncthreads_and(in) || !kPbc;
    if (fast)
      local_tile<kPbc, true>(plane, values, group, n, h, L, inv, edge, a.r2,
                             acc);
    else
      local_tile<kPbc, false>(plane, values, group, n, h, L, inv, edge, a.r2,
                              acc);
  }

  // the warps' sums meet in shared memory, added in warp order
  double2* part = values;
  __syncthreads();
  if (group > 0) part[(group - 1) * 32 + lane] = acc;
  __syncthreads();
  if (group > 0 || m >= a.n_heads) return;
  for (int g = 1; g < kGroups; ++g) {
    const double2 o = part[(g - 1) * 32 + lane];
    acc.x += o.x;
    acc.y += o.y;
  }
  a.out[static_cast<size_t>(b) * a.n_heads + m] =
      make_float2(static_cast<float>(acc.x), static_cast<float>(acc.y));
}

// A launch over (head tiles of 32, frames) with `bytes` of dynamic shared
// memory.
template <class Kernel, class Args>
cudaError_t launch_grid(Kernel kernel, const Args& a, int n_frames,
                        size_t bytes, cudaStream_t stream) {
  cudaError_t err = gorder::allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_heads + 31) / 32, n_frames);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// What the kernels take: a tile of at least one atom, a margin no narrower
// than kMinMargin (a NaN refused too).
bool valid_args(int tile, float margin) {
  return tile > 0 && margin >= kMinMargin;
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream` and returns the first
// error (0 = launched); the outputs are written whole. n_frames <= 65535;
// the arguments as `valid_args` takes them, and the shared memory of a
// tile (16 bytes an atom for normal_cloud, 24 for local_sums) or of the
// warps' partial sums, whichever is larger, at most 227 KiB.

// heads (B, M, 3) f32, cloud (B, C, 3) f32, box (B, 3) f32 → counts
// (B, M) f32 and cov (B, M, 6) f32; r2 = f32(r)*f32(r).
int normal_cloud(const void* heads, const void* cloud, const void* box,
                 void* counts, void* cov, int n_frames, int n_heads,
                 int n_cloud, float r2, float margin, int pbc, int tile,
                 void* stream) {
  if (n_frames < 0 || n_frames > 65535 || n_heads < 0 || n_cloud < 0 ||
      !valid_args(tile, margin))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = std::max(sizeof(float4) * static_cast<size_t>(tile),
                                sizeof(CloudSums) * 32 * (kGroups - 1));
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n_heads == 0) return 0;
  const CloudArgs a{static_cast<const float*>(heads),
                    static_cast<const float*>(cloud),
                    static_cast<const float*>(box),
                    static_cast<float*>(counts),
                    static_cast<float*>(cov),
                    n_heads,
                    n_cloud,
                    tile,
                    r2,
                    margin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      pbc ? launch_grid(normal_cloud_kernel<true>, a, n_frames, bytes, s)
          : launch_grid(normal_cloud_kernel<false>, a, n_frames, bytes, s));
}

// members (B, Nm, 4) f32, heads (B, M, 2) f32, box (B, 2) f32 (read with
// pbc only) → out (B, M, 2) f32; r2 = f32(r)*f32(r).
int local_sums(const void* members, const void* heads, const void* box,
               void* out, int n_frames, int n_members, int n_heads, float r2,
               float margin, int pbc, int tile, void* stream) {
  if (n_frames < 0 || n_frames > 65535 || n_heads < 0 || n_members < 0 ||
      !valid_args(tile, margin))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      std::max((sizeof(double2) + sizeof(float2)) * static_cast<size_t>(tile),
               sizeof(double2) * 32 * (kGroups - 1));
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n_heads == 0) return 0;
  const LocalArgs a{static_cast<const float4*>(members),
                    static_cast<const float2*>(heads),
                    static_cast<const float2*>(box),
                    static_cast<float2*>(out),
                    n_members,
                    n_heads,
                    tile,
                    r2,
                    margin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      pbc ? launch_grid(local_sums_kernel<true>, a, n_frames, bytes, s)
          : launch_grid(local_sums_kernel<false>, a, n_frames, bytes, s));
}

}  // extern "C"

// Device code shared by the order-parameter kernels (p2.cu, ua.cu): the
// minimum image, the reference's fixed-point sample, the per-block table
// of per-type [sum, count] int64 that a warp adds its samples to with one
// add where its lanes hold one type (warp-aggregated), the grid that gives
// a block a whole frame, and the ordermap table (MapTable) that each
// sample is added to in global memory. The tables are (2, T), or (3, 2, T)
// for the with_leaflets variants: total, upper (class 0) and lower (class
// 1); a sample whose molecule's class is neither 0 nor 1 counts in total
// only, as the TPU kernels' masks do (gorder_tpu/ops/pallas_p2.py:220-222).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gorder {

// The default shared memory a block may use without opting in.
constexpr size_t kSharedBytes = 48 * 1024;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kWarpSize = 32;

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

// How a block's shared table reaches the frame's rows of the output:
// stored (the block owns the frame and writes every entry, zeros
// included), added with plain loads and stores (the block owns the frame
// and a launch before it on the stream stored the rows), or added with
// global atomics (several blocks share the frame; the rows were zeroed or
// stored before).
enum Flush : int { kStore = 0, kAdd = 1, kAtomic = 2 };

// A block's table of per-type [sum, count] for its frame: (kClasses, 2, T)
// in shared memory when kShared, else the frame's rows of the output,
// which a launch then adds into with global atomics.
//
// Samples arrive a warp at a time (`add`). Where the lanes hold one type,
// as the type-major layouts give, the warp's int32 sum is one redux.sync
// (a sample is |q| <= 10^6, so 32 of them fit int32), its count a
// popcount, and one lane does the two int64 atomics, instead of 32 lanes
// serialized on one address. A warp across the boundary of two type runs
// makes two such groups; the other lanes of a warp of mixed types add
// their own samples: there __match_any_sync and a redux.sync per group
// cost more than the atomics they save (on an H100 the AA batch permuted
// molecule-major ran 4.6x slower with them than with per-lane atomics;
// gorder_tpu_torch/diagnostics/layout.py). Integer sums are exact in any
// order.
template <bool kShared, int kClasses>
struct TypeTable {
  static_assert(kClasses == 1 || kClasses == 3, "total, or total/upper/lower");
  unsigned long long* acc;
  unsigned long long* frame_out;
  int n_types;

  // Every thread of the block calls this (it synchronizes when kShared).
  __device__ __forceinline__ TypeTable(unsigned long long* smem,
                                       unsigned long long* out, int b,
                                       int types)
      : acc(kShared ? smem
                    : out + static_cast<size_t>(b) * kClasses * 2 * types),
        frame_out(out + static_cast<size_t>(b) * kClasses * 2 * types),
        n_types(types) {
    if constexpr (kShared) {
      for (int k = threadIdx.x; k < kClasses * 2 * n_types; k += blockDim.x)
        acc[k] = 0;
      __syncthreads();
    }
  }

  __device__ __forceinline__ void add_to(int c, int t, int sum,
                                         int count) const {
    unsigned long long* row = acc + static_cast<size_t>(c) * 2 * n_types;
    atomicAdd(row + t, static_cast<unsigned long long>(
                           static_cast<long long>(sum)));
    atomicAdd(row + n_types + t, static_cast<unsigned long long>(count));
  }

  // The lanes `group` of the warp, all of type t, as one add per class:
  // their sum is one full-warp redux.sync of the group's samples (every
  // lane takes part with the same mask), their count a popcount, and the
  // group's first lane adds both. up, lo: the lanes of class 0 and 1.
  __device__ __forceinline__ void add_group(int t, unsigned group, int qi,
                                            unsigned up, unsigned lo) const {
    const unsigned lane = 1u << (threadIdx.x & (kWarpSize - 1));
    const int mine = (group & lane) ? qi : 0;
    const int sum = __reduce_add_sync(kFullWarp, mine);
    const bool leader = lane == (group & (0u - group));
    if constexpr (kClasses == 3) {
      const int sum_up = __reduce_add_sync(kFullWarp, (up & lane) ? mine : 0);
      const int sum_lo = __reduce_add_sync(kFullWarp, (lo & lane) ? mine : 0);
      if (leader) {
        if (const int n = __popc(group & up)) add_to(1, t, sum_up, n);
        if (const int n = __popc(group & lo)) add_to(2, t, sum_lo, n);
      }
    }
    if (leader) add_to(0, t, sum, __popc(group));
  }

  // Every lane of the warp calls this together, converged: lane sample q
  // of type t, of a molecule in leaflet class cls (read only by the
  // with_leaflets table), counted when `valid`. A lane that counts nothing
  // (a masked frame, a sample outside the geometry, the ragged end of a
  // tile) passes valid = false. The lanes of the first counting lane's
  // type are one group; so, when it differs, are those of the last one's
  // (a warp across the boundary of two type runs); any other lane (a warp
  // of mixed types) adds its own sample, to an address that the warp's
  // other lanes seldom share.
  __device__ __forceinline__ void add(int t, long long q, bool valid,
                                      int cls) const {
    const unsigned active = __ballot_sync(kFullWarp, valid);
    if (active == 0u) return;  // warp-uniform
    const int qi = valid ? static_cast<int>(q) : 0;
    const int first = __shfl_sync(kFullWarp, t, __ffs(active) - 1);
    const int last = __shfl_sync(kFullWarp, t, 31 - __clz(active));
    const unsigned up =
        kClasses == 3 ? __ballot_sync(kFullWarp, valid && cls == 0) : 0u;
    const unsigned lo =
        kClasses == 3 ? __ballot_sync(kFullWarp, valid && cls == 1) : 0u;
    const unsigned head = active & __ballot_sync(kFullWarp, t == first);
    add_group(first, head, qi, up, lo);
    unsigned rest = active & ~head;
    if (rest == 0u) return;  // one type: the type-major layouts' case
    if (last != first) {
      const unsigned tail = rest & __ballot_sync(kFullWarp, t == last);
      add_group(last, tail, qi, up, lo);
      rest &= ~tail;
    }
    if (rest & (1u << (threadIdx.x & (kWarpSize - 1)))) {
      add_to(0, t, qi, 1);
      if constexpr (kClasses == 3) {
        if (cls == 0) add_to(1, t, qi, 1);
        else if (cls == 1) add_to(2, t, qi, 1);
      }
    }
  }

  // Every thread of the block calls this once, after its last add.
  __device__ __forceinline__ void flush(int mode) const {
    if constexpr (kShared) {
      __syncthreads();
      for (int k = threadIdx.x; k < kClasses * 2 * n_types; k += blockDim.x) {
        const unsigned long long v = acc[k];
        if (mode == kStore) {
          frame_out[k] = v;
        } else if (mode == kAdd) {
          frame_out[k] += v;
        } else if (v != 0ULL) {
          atomicAdd(frame_out + k, v);
        }
      }
    }
  }
};

// Shared-memory bytes of a kShared table of n_types.
__host__ __device__ inline size_t table_bytes(int n_types, int n_classes) {
  return static_cast<size_t>(n_classes) * 2 * static_cast<size_t>(n_types) *
         sizeof(unsigned long long);
}

// Whether a table fits the default shared memory: T <= 3072 for (2, T),
// T <= 1024 for (3, 2, T); larger tables add straight into the output.
inline bool table_fits(int n_types, int n_classes) {
  return table_bytes(n_types, n_classes) <= kSharedBytes;
}

// How a launch over n_frames frames of n_items samples (bonds, targets)
// cuts its work: `splits` blocks a frame, grid (splits, B), and each warp
// of a block a contiguous chunk of `chunk` items (a multiple of the warp
// size, so that every lane of a warp runs the same iterations). One block
// a frame when there are frames enough to fill the card twice over;
// otherwise a frame is split, at most until each warp has one iteration.
struct Grid {
  int splits;
  int chunk;
};

inline Grid frame_grid(int n_frames, int n_items, int threads) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int warps = threads / kWarpSize;
  const int most = (n_items + threads - 1) / threads;
  int splits = (2 * sms + n_frames - 1) / n_frames;
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  const int per_warp = (n_items + splits * warps - 1) / (splits * warps);
  return Grid{splits, (per_warp + kWarpSize - 1) / kWarpSize * kWarpSize};
}

// The flush (*mode) of a launch that writes (accumulate = 0) or adds into
// (accumulate = 1) an output of out_bytes, zeroing the output on the
// stream when its blocks will add with atomics into rows nothing has
// written yet.
inline cudaError_t flush_mode(bool shared, int splits, int accumulate,
                              void* out, size_t out_bytes,
                              cudaStream_t stream, int* mode) {
  if (shared && splits == 1) {
    *mode = accumulate ? kAdd : kStore;
    return cudaSuccess;
  }
  *mode = kAtomic;
  return accumulate ? cudaSuccess
                    : cudaMemsetAsync(out, 0, out_bytes, stream);
}

// Opt a kernel in to `bytes` of dynamic shared memory when they pass the
// default 48 KiB (up to the card's 227 KiB a block).
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The per_bond_normal variants' normal of molecule `mol` in frame b:
// normals (B, M, 3) f32, dynamic or manual, not necessarily unit. A
// frame's row is 12 * M bytes and stays in L1/L2 across its samples.
__device__ __forceinline__ float3 molecule_normal(const float* normals, int b,
                                                  int n_molecules, int mol) {
  const float* n = normals + (static_cast<size_t>(b) * n_molecules + mol) * 3;
  return make_float3(n[0], n[1], n[2]);
}

// n2 = max((nx*nx + ny*ny) + nz*nz, 1e-18): the squared length of a
// per-molecule normal as both JAX kernels take it (pallas_p2.py:133,
// core/ua.py:284).
__device__ __forceinline__ float normal_norm2(float3 n) {
  return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(n.x, n.x), __fmul_rn(n.y, n.y)),
                         __fmul_rn(n.z, n.z)),
               1e-18f);
}

// An ordermap's grid (gorder_tpu_torch/core/ordermap.py MapSpec) and its
// run-long state, passed by value from ctypes. The state is int64
// (kClasses, 2, T * n0 * n1 + 1): class x [sum of samples, count] x the
// type-major cells (t * n0 + i0) * n1 + i1, then the dump entry that takes
// every sample outside the grid. state null: the run has no map.
struct MapGrid {
  unsigned long long* state;
  float start0, start1;  // f32 of the grid's starts and bin sizes, as the
  float bin0, bin1;      // JAX package's map_cells takes them
  int ax0, ax1;          // the plane's two axes (0 x, 1 y, 2 z)
  int n0, n1;            // tiles along each
};

__device__ __forceinline__ float component(float x, float y, float z,
                                           int axis) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

// The tile of one plane component p: floor((p - start) / bin + 0.5) in
// f32 (gorder_tpu/core/ordermap.py:90-91), or -1 outside [0, n). Bin
// boundaries are sensitive to the last ulp, so every step is correctly
// rounded.
__device__ __forceinline__ int map_tile(float p, float start, float bin,
                                        int n) {
  const float f = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(p, start), bin), 0.5f));
  return (f >= 0.0f && f < static_cast<float>(n)) ? static_cast<int>(f) : -1;
}

// A kernel's view of the map: finds a sample's cell by its bond midpoint
// and adds the sample and a count of 1 to it with 64-bit global atomics, in
// total and, with kClasses == 3, in the upper or lower row (as TypeTable).
template <int kClasses>
struct MapTable {
  MapGrid g;
  long long n_entries;  // T * n0 * n1 + 1, the dump last

  __device__ __forceinline__ MapTable(const MapGrid& grid, int n_types)
      : g(grid),
        n_entries(static_cast<long long>(n_types) * grid.n0 * grid.n1 + 1) {}

  __device__ __forceinline__ bool active() const { return g.state != nullptr; }

  // The cell of a sample of type t whose bond midpoint is (mx, my, mz).
  __device__ __forceinline__ long long cell(int t, float mx, float my,
                                            float mz) const {
    const int i0 =
        map_tile(component(mx, my, mz, g.ax0), g.start0, g.bin0, g.n0);
    const int i1 =
        map_tile(component(mx, my, mz, g.ax1), g.start1, g.bin1, g.n1);
    if (i0 < 0 || i1 < 0) return n_entries - 1;
    return (static_cast<long long>(t) * g.n0 + i0) * g.n1 + i1;
  }

  __device__ __forceinline__ void add_to(int c, long long cell,
                                         long long q) const {
    unsigned long long* row = g.state + static_cast<size_t>(c) * 2 * n_entries;
    atomicAdd(row + cell, static_cast<unsigned long long>(q));
    atomicAdd(row + n_entries + cell, 1ULL);
  }

  __device__ __forceinline__ void add(long long cell, long long q,
                                      int cls) const {
    add_to(0, cell, q);
    if constexpr (kClasses == 3) {
      if (cls == 0) add_to(1, cell, q);
      else if (cls == 1) add_to(2, cell, q);
    }
  }
};

// A geometry selection's inside test (gorder_tpu_torch/core/geometry.py,
// port of gorder_tpu/core/geometry.py inside_mask), passed by value from
// ctypes: kind 0 cuboid, 1 cylinder, 2 sphere (-1: no geometry); per axis
// whether its span is bounded, and the f32 of its lower end lo and of its
// extent hi - lo, each rounded once from the f64 value as the JAX package's
// weak typing rounds them; the f32 of radius * radius when has_radius. A
// cylinder's span lies on its orientation axis only.
struct GeoShape {
  int kind, invert, orientation, has_radius;
  int bounded[3];
  float lo[3];
  float extent[3];
  float radius2;
};

// One axis of the test: the corner-relative coordinate delta - lo, wrapped
// into the box with floor(shifted / L) under PBC, within [0, extent].
__device__ __forceinline__ bool geo_axis_ok(const GeoShape& g, int axis,
                                            float delta, float box,
                                            bool pbc) {
  if (!g.bounded[axis]) return true;
  float shifted = __fsub_rn(delta, g.lo[axis]);
  if (pbc) {
    shifted = __fsub_rn(shifted,
                        __fmul_rn(box, floorf(__fdiv_rn(shifted, box))));
  }
  return shifted >= 0.0f && shifted <= g.extent[axis];
}

// Whether the point p lies inside the shape placed at ref (the frame's
// reference point), in a box with diagonal L: the cylinder's radial and
// the sphere's distances take the minimum image under PBC (rint: half to
// even), and the sphere's d2 is (d0*d0 + d1*d1) + d2*d2, as jnp.sum adds
// a size-3 axis; every step correctly rounded.
__device__ __forceinline__ bool geo_inside(const GeoShape& g, float3 p,
                                           float3 ref, float3 L, bool pbc) {
  const float rel[3] = {__fsub_rn(p.x, ref.x), __fsub_rn(p.y, ref.y),
                        __fsub_rn(p.z, ref.z)};
  const float box[3] = {L.x, L.y, L.z};
  bool ok;
  if (g.kind == 0) {
    ok = geo_axis_ok(g, 0, rel[0], box[0], pbc) &&
         geo_axis_ok(g, 1, rel[1], box[1], pbc) &&
         geo_axis_ok(g, 2, rel[2], box[2], pbc);
  } else if (g.kind == 1) {
    const int a = g.orientation;
    const int p0 = a == 0 ? 1 : 0;
    const int p1 = a == 2 ? 1 : 2;
    float d0 = rel[p0], d1 = rel[p1];
    if (pbc) {
      d0 = min_image(d0, box[p0]);
      d1 = min_image(d1, box[p1]);
    }
    const bool radial =
        !g.has_radius ||
        __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)) <= g.radius2;
    ok = radial && geo_axis_ok(g, a, rel[a], box[a], pbc);
  } else {
    float d[3] = {rel[0], rel[1], rel[2]};
    if (pbc) {
      for (int k = 0; k < 3; ++k) d[k] = min_image(d[k], box[k]);
    }
    ok = !g.has_radius ||
         __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                   __fmul_rn(d[2], d[2])) <= g.radius2;
  }
  return g.invert ? !ok : ok;
}

// The leaflet class of the molecule `mol` in frame b: classes (B, M) int32.
// Without classes (the plain variants) every sample is class 0, which only
// the (2, T) table reads, and ignores.
__device__ __forceinline__ int leaflet_class(const int32_t* classes, int b,
                                             int n_molecules, int mol) {
  return classes == nullptr
             ? 0
             : classes[static_cast<size_t>(b) * n_molecules + mol];
}

}  // namespace gorder

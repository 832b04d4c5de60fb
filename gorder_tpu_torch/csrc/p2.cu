// P2 order-parameter kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gorder_tpu/ops/pallas_p2.py `_p2_kernel` (with
// its tile math `_p2_limbs` and reduction `_accumulate`), in its
// `resid_input` variant (b7 wire) and its positions variants (the
// single-rounding integer difference, on int16 or int32 XTC integers as
// the TPU kernel takes either at pallas_p2.py:287-294, and the f32 pair
// difference), each with and without `with_leaflets` (the class plane
// gathered at pallas_p2.py:393-400, the masks at :220-222).
//
// Per sample (frame b, bond i): bond vector d -> minimum image
// d - L*rint(d/L) -> proj = d.n, d2 = dx*dx + dy*dy + dz*dz ->
// cos2 = proj^2 / max(d2, 1e-18) -> S = 1.5*cos2 - 0.5 -> the reference's
// fixed-point sample q = llround(f64(S) * 1e6) (src/analysis/order.rs:21-26,
// rounded half away from zero; the f64 product is exact). Every f32 step is
// written with an _rn intrinsic, so no FMA is contracted and the division
// is correctly rounded, whatever the flags: the integers equal the plain
// PyTorch version's (gorder_tpu_torch/core/order.py p2_sums) bit for bit.
//
// The TPU kernel splits q into 7-bit limbs and sums them with one-hot
// matmuls on the MXU, because a TPU kernel has no f64 and no integer
// atomics. Here q is summed directly in int64, exact in any order, so the
// result is deterministic.
//
// The b7 wire (B7Input; the TPU kernel's resid_input, whose residuals the
// JAX package unpacks in XLA before the pallas_call) comes in as the
// decoder ships it: pk (B, stride) uint8 7-bit codes, value v at bit 7v
// of its frame's row, little endian; gp (B, cap) u16 escape gaps and vl
// (B, cap) int16 escape values; base (3N,) int32; scale (B,) f32. The
// kernel unpacks in registers what engine/wire.py b7_residuals and the
// base add give, d = f32(base + r) * s, bit for bit, and never writes the
// (B, 3N) residuals to device memory. The block first scans its frame's
// gaps into a list of escapes in shared memory -- positions
// cumsum(gaps) - 1 of the nonzero gaps (a gap of 0 is padding), strictly
// increasing, those past the last value dropped -- with their values; a
// warp then finds its first escape by one binary search and walks the
// list alongside its bonds, every lane taking the escapes of its values.
//
// What bounds it on this card: the bytes it must move, about 7/8 byte a
// value of b7 codes (2.6 bytes a sample) plus 4 bytes an escape slot and the
// (3N,) base once, against about 2 bytes a value of unpacked residuals
// written and read again before. Arithmetic is a few dozen flops a sample.
// What the design does about it:
//   - the unpack is fused into the kernel's input, so the residuals never
//     reach device memory;
//   - a block owns one frame (two per SM at the main path's B = 512) and
//     each warp a contiguous chunk of its bonds, so that the block ends by
//     storing its frame's rows of the type table with plain stores: no
//     global atomics and no zeroing of the output. With fewer frames than
//     twice the SMs, a frame is split over several blocks, which add their
//     tables with global atomics into an output zeroed on the stream;
//   - the bonds are laid out type-major (topology/classify.py
//     compile_bonds: for each bond type, that bond of every molecule), so
//     the 32 lanes of a warp nearly always hold one type: the per-type sums
//     are warp-aggregated (common.cuh TypeTable), one add per warp instead
//     of 32 serialized shared atomics on one address.
//
// with_leaflets: the (B, M) int32 class plane and each bond's molecule
// bond_mol (N,) int32 give the sample's class cls = classes[b, bond_mol[i]];
// the table becomes (3, 2, T) -- total, upper (cls 0), lower (cls 1) --
// and the output (B, 3, 2, T). The table then fits shared memory only for
// T <= 1024; above that the kernel adds into the output with global
// atomics (fed by the same warp-aggregated adds). The class costs one more
// 4-byte gather per sample (the plane row of a frame is M * 4 bytes and
// stays in L1/L2) and two more warp reductions.
//
// per_bond_normal (kMolNormal; replaces pallas_p2.py:128-134 with the
// operand gather at :343-349): dynamic or manual membrane normals, (B, M,
// 3) f32, one per molecule and frame. Each sample reads its molecule's
// normal n = normal[(b*M + bond_mol[i])*3 ..] and takes
// proj = (dx*nx + dy*ny) + dz*nz, n2 = max((nx*nx + ny*ny) + nz*nz, 1e-18)
// and cos2 = proj^2 / (max(d2, 1e-18) * n2): one product in the
// denominator, as gorder_tpu/core/order.py:185-192 writes it. With
// n = (0, 0, 1) that is the static chain bit for bit. The TPU wrapper
// materializes (B, N, 3) per-bond normal planes in HBM before its
// pallas_call; here the kernel gathers from the (B, M, 3) tensor, whose
// 3 KB frame row (M = 256) stays in L1/L2. It combines with the class
// plane (both read bond_mol). What bounds it: 12 more bytes gathered per
// sample (from cache; the bytes the function must move are the (B, M, 3)
// normals once, 12 * M per frame) and about 8 more f32 operations.
//
// pair_quantized (PairIntPositions; replaces pallas_p2.py:287-304):
// integer positions of an ordermap run take the pair difference of the
// dequantized positions, d = f32(q_b)*s - f32(q_a)*s, the reference's
// f32-position arithmetic, instead of the single rounding f32(q_b - q_a)*s:
// map-bin boundaries are sensitive to the last ulp, and XTC positions at
// precision 1000 put many bond midpoints exactly on a 0.1 nm boundary. The
// type sums
// take the same d (gorder_tpu/core/order.py:144-162).
//
// Ordermaps (the positions inputs, pair integer and f32; with and without
// classes and per-molecule normals): the JAX package computes each sample
// twice, once in the Pallas kernel for the type sums and once in XLA for
// the map (core/order.py `_map_only_impl`, a segment_sum of 7-bit f32
// limbs added up on the host every batch). Here the thread that computes a
// sample adds it to its map cell too, with two 64-bit global atomics per
// class (common.cuh MapTable): the cell of the bond midpoint pa + d*0.5
// after the minimum image (core/order.py:204). Neighbouring samples fall
// in different cells, so these adds stay per sample. The map is one int64
// state on the device for the whole run, exact in any order. A null state
// pointer is a uniform branch, not another template axis. What bounds it:
// the map adds 2 (4 with classes) global atomics per sample into a table
// of T * n0 * n1 entries per row (1.3 M for the AA membrane at 0.1 nm, 21
// MB a class: above the 50 MB L2 with classes), and about 14 f32
// operations.
//
// with_geom (replaces pallas_p2.py:204-206 and :218-219, with the plane
// built at :384-391) and diff_input (:276-286): a geometry selection keeps
// only the samples whose bond midpoint lies inside the shape. The TPU
// kernel multiplies a (B, N) f32 inside plane into the mask of every
// accumulator; here every entry point takes the (B, ceil(N/8)) uint8
// bitplane `geo` (bit i & 7 of byte i >> 3 is bond i), the layout in which
// the XTC decoder evaluates it host-side (native/xdr.cpp xtc_geo_mask,
// the b7geo wire and the coordinate wires' *G kinds) and in which the
// device-computed mask is packed (engine/wire.py pack_geo_bits). A lane
// whose bond bit is 0 loads nothing of its bond and adds nothing to the
// type sums, the counts or the map, but stays in the warp's collective
// add. A null `geo` is a uniform branch, not another template axis.
// diff_input is the TPU kernel's input of bond vectors (the b7 wires
// dequantized outside the kernel); the b7geo wire hands this kernel its
// packed wire instead, and the b7 input rebuilds the same f32(base + r) * s
// in registers (:192-197), so diff_input needs no entry point of its own.
// What bounds it: 1/8 byte a bond more, against the TPU kernel's 4-byte
// f32 plane.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using gorder::kWarpSize;
using gorder::min_image;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarpSize;
constexpr int kMaxEscapes = 8192;  // the b7 wire's largest cap

// One sample of the (min-imaged) bond vector d against the normal n: the
// static one, or (kMolNormal) the bond's molecule's, with its n2
// (gorder::normal_norm2).
template <bool kMolNormal>
__device__ __forceinline__ long long p2_sample(float3 d, float3 n,
                                               float n2) {
  const float proj =
      __fadd_rn(__fadd_rn(__fmul_rn(d.x, n.x), __fmul_rn(d.y, n.y)),
                __fmul_rn(d.z, n.z));
  const float d2 =
      __fadd_rn(__fadd_rn(__fmul_rn(d.x, d.x), __fmul_rn(d.y, d.y)),
                __fmul_rn(d.z, d.z));
  const float den = kMolNormal ? __fmul_rn(fmaxf(d2, 1e-18f), n2)
                               : fmaxf(d2, 1e-18f);
  const float cos2 = __fdiv_rn(__fmul_rn(proj, proj), den);
  const float sch = __fsub_rn(__fmul_rn(1.5f, cos2), 0.5f);
  return gorder::quantum(sch);
}

// A frame's escapes in shared memory: value positions, strictly
// increasing, and their values; n of them (none for the positions inputs).
struct Escapes {
  const int* pos;
  const int16_t* val;
  int n;

  // The first escape at a position >= v. Every lane of a warp asks for
  // the same v, so the reads are broadcasts.
  __device__ __forceinline__ int seek(int v) const {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pos[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  }
};

// Each input gives sample (b, i)'s bond vector d and, when kPositions, the
// f32 position pa of its first atom (the map's midpoint reads it). Every
// lane of a warp calls it together, for bonds i0 + lane; a lane with
// `load` false loads nothing (its bond is past the chunk, or outside the
// geometry) and leaves d unset.

// b7 wire, packed (see the header): d = f32(base + r) * s.
struct B7Input {
  static constexpr bool kPositions = false;
  const uint8_t* __restrict__ pk;
  const uint16_t* __restrict__ gp;
  const int16_t* __restrict__ vl;
  const int32_t* __restrict__ base;
  const float* __restrict__ scale;
  int stride, cap, n_values;

  // Shared bytes of the escape list.
  size_t shared_bytes() const {
    return static_cast<size_t>(cap) * (sizeof(int) + sizeof(int16_t));
  }

  // Every thread of the block calls this: frame b's escapes into `smem`.
  // Each thread scans a contiguous segment of the gaps; the running
  // [gap sum, nonzero count] is packed as sum << 16 | count (a sum below
  // 8192 * 65535 < 2^30, a count up to 8192).
  __device__ Escapes prologue(int b, unsigned char* smem) const {
    __shared__ unsigned long long warp_total[kWarps];
    __shared__ int n_escapes;
    int* pos = reinterpret_cast<int*>(smem);
    int16_t* val = reinterpret_cast<int16_t*>(pos + cap);
    const uint16_t* g = gp + static_cast<size_t>(b) * cap;
    const int16_t* v = vl + static_cast<size_t>(b) * cap;
    const int seg = (cap + kThreads - 1) / kThreads;
    const int lo = min(static_cast<int>(threadIdx.x) * seg, cap);
    const int hi = min(lo + seg, cap);
    unsigned long long mine = 0;
    for (int j = lo; j < hi; ++j) {
      const unsigned gj = g[j];
      mine += (static_cast<unsigned long long>(gj) << 16) | (gj != 0u);
    }
    const int lane = threadIdx.x & (kWarpSize - 1);
    const int warp = threadIdx.x / kWarpSize;
    unsigned long long incl = mine;
    for (int o = 1; o < kWarpSize; o <<= 1) {
      const unsigned long long x = __shfl_up_sync(gorder::kFullWarp, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == kWarpSize - 1) warp_total[warp] = incl;
    if (threadIdx.x == 0) n_escapes = 0;
    __syncthreads();
    unsigned long long run = incl - mine;
    for (int w = 0; w < warp; ++w) run += warp_total[w];
    int written = 0;
    for (int j = lo; j < hi; ++j) {
      const unsigned gj = g[j];
      if (gj == 0u) continue;  // padding: overrides nothing
      run += (static_cast<unsigned long long>(gj) << 16) | 1ULL;
      const long long p = static_cast<long long>(run >> 16) - 1;
      if (p >= n_values) break;  // past the last value, as every later one
      written = static_cast<int>(run & 0xFFFFULL);
      pos[written - 1] = static_cast<int>(p);
      val[written - 1] = v[j];
    }
    if (written) atomicMax(&n_escapes, written);
    __syncthreads();
    return Escapes{pos, val, n_escapes};
  }

  // ((c + 64) & 127) - 64 of the 7-bit code in the low bits of x
  static __device__ __forceinline__ int code(unsigned x) {
    return static_cast<int>((x + 64u) & 127u) - 64;
  }

  // e: the warp's next escape, advanced past the values of bonds
  // i0 .. i0 + 31 (warp-uniform).
  __device__ __forceinline__ void operator()(int b, int i0, int i, bool load,
                                             const Escapes& esc, int& e,
                                             float3& d, float3&) const {
    int r0 = 0, r1 = 0, r2 = 0;
    if (load) {
      // bond i's three codes: bits 21i .. 21i + 20 of the row, in 3 or 4
      // bytes, every one inside the row
      const long long bit = 21LL * i;
      const uint8_t* p = pk + static_cast<size_t>(b) * stride + (bit >> 3);
      const int sh = static_cast<int>(bit & 7);
      unsigned w = 0;
      for (int k = 0; k < (sh + 28) >> 3; ++k) w |= unsigned(p[k]) << (8 * k);
      r0 = code(w >> sh);
      r1 = code(w >> (sh + 7));
      r2 = code(w >> (sh + 14));
    }
    const int first = 3 * i;
    const int stop = 3 * (i0 + kWarpSize);
    for (; e < esc.n && esc.pos[e] < stop; ++e) {
      const int off = esc.pos[e] - first;
      const int x = esc.val[e];
      r0 = off == 0 ? x : r0;
      r1 = off == 1 ? x : r1;
      r2 = off == 2 ? x : r2;
    }
    if (load) {
      const int32_t* bs = base + 3 * i;
      const float s = scale[b];
      d = make_float3(__fmul_rn(__int2float_rn(bs[0] + r0), s),
                      __fmul_rn(__int2float_rn(bs[1] + r1), s),
                      __fmul_rn(__int2float_rn(bs[2] + r2), s));
    }
  }
};

// The positions inputs read no escapes.
struct NoEscapes {
  size_t shared_bytes() const { return 0; }
  __device__ Escapes prologue(int, unsigned char*) const {
    return Escapes{nullptr, nullptr, 0};
  }
};

// Integer positions: x (B, A, 3) XTC integers, int16 (the i16 and i12
// wires) or int32 (s6 and d8, for trajectories whose integers overflow
// int16), scale (B,) f32: d = f32(q_b - q_a) * s, the single rounding of
// the exact difference. int(q_b) - int(q_a) is exact for int32 input as
// long as |q| < 2^30, and __int2float_rn of the difference and of q is
// exact for |q| < 2^24 (16,777 nm at precision 1000): the JAX package's
// f32(int32) casts round the same values the same way. What bounds the
// int32 input: the bytes of the positions, 12 an atom a frame against
// int16's 6 (each gathered once per bond end, from L1/L2); the arithmetic
// is the same.
template <class T>
struct IntPositions : NoEscapes {
  using Value = T;
  static constexpr bool kPositions = false;
  const T* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  const float* __restrict__ scale;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int, int i, bool load,
                                             const Escapes&, int&, float3& d,
                                             float3&) const {
    if (!load) return;
    const T* xb = x + static_cast<size_t>(b) * n_atoms * 3;
    const T* pa = xb + 3 * atom_a[i];
    const T* pb = xb + 3 * atom_b[i];
    const float s = scale[b];
    d = make_float3(__fmul_rn(__int2float_rn(int(pb[0]) - int(pa[0])), s),
                    __fmul_rn(__int2float_rn(int(pb[1]) - int(pa[1])), s),
                    __fmul_rn(__int2float_rn(int(pb[2]) - int(pa[2])), s));
  }
};

// Integer positions of an ordermap run (pair_quantized), int16 or int32:
// the positions dequantized first, p = f32(q) * s, then d = p_b - p_a.
template <class T>
struct PairIntPositions : NoEscapes {
  using Value = T;
  static constexpr bool kPositions = true;
  const T* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  const float* __restrict__ scale;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int, int i, bool load,
                                             const Escapes&, int&, float3& d,
                                             float3& pa) const {
    if (!load) return;
    const T* xb = x + static_cast<size_t>(b) * n_atoms * 3;
    const T* qa = xb + 3 * atom_a[i];
    const T* qb = xb + 3 * atom_b[i];
    const float s = scale[b];
    pa = make_float3(__fmul_rn(__int2float_rn(qa[0]), s),
                     __fmul_rn(__int2float_rn(qa[1]), s),
                     __fmul_rn(__int2float_rn(qa[2]), s));
    d = make_float3(__fsub_rn(__fmul_rn(__int2float_rn(qb[0]), s), pa.x),
                    __fsub_rn(__fmul_rn(__int2float_rn(qb[1]), s), pa.y),
                    __fsub_rn(__fmul_rn(__int2float_rn(qb[2]), s), pa.z));
  }
};

// f32 wire: x (B, A, 3) f32 positions: d = p_b - p_a.
struct FloatPositions : NoEscapes {
  static constexpr bool kPositions = true;
  const float* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int, int i, bool load,
                                             const Escapes&, int&, float3& d,
                                             float3& pa) const {
    if (!load) return;
    const float* xb = x + static_cast<size_t>(b) * n_atoms * 3;
    const float* a = xb + 3 * atom_a[i];
    const float* c = xb + 3 * atom_b[i];
    pa = make_float3(a[0], a[1], a[2]);
    d = make_float3(__fsub_rn(c[0], a[0]), __fsub_rn(c[1], a[1]),
                    __fsub_rn(c[2], a[2]));
  }
};

// What a bond reads by its molecule: the (B, M) class plane (with_leaflets)
// and, in the per_bond_normal variant, the (B, M, 3) normals passed as
// `normal`; bond_mol is null when neither is read.
struct Molecules {
  const int32_t* __restrict__ classes;
  const int32_t* __restrict__ bond_mol;
  int n_molecules;
};

// Whether bond i of frame b lies inside the geometry: bit i & 7 of byte
// i >> 3 of the frame's row of the (B, ceil(N/8)) bitplane; every bond
// without one (geo null).
__device__ __forceinline__ bool inside(const uint8_t* geo, int b, int i,
                                       int n_bonds) {
  if (geo == nullptr) return true;
  const size_t row = static_cast<size_t>(b) * ((n_bonds + 7) >> 3);
  return (geo[row + (i >> 3)] >> (i & 7)) & 1;
}

// What every launch of one entry point shares: normal (3,) f32, or
// (B, M, 3) f32 when kMolNormal; geo: the geometry bitplane (null without
// one); map: the ordermap, added into (positions inputs only; state null
// without one); chunk: the bonds of a warp (gorder::frame_grid); flush:
// how a block's table reaches out, (B, kClasses, 2, T) int64.
struct Args {
  const float* box;
  const float* normal;
  const uint8_t* mask;
  const int32_t* bond_type;
  Molecules lf;
  const uint8_t* geo;
  gorder::MapGrid map;
  int n_bonds, n_types, pbc, chunk, flush;
  unsigned long long* out;
};

// grid (splits, B): block (s, b) takes frame b's bonds
// [s * kWarps * chunk, (s + 1) * kWarps * chunk), a chunk a warp.
template <class Input, bool kShared, int kClasses, bool kMolNormal>
__global__ void __launch_bounds__(kThreads)
p2_kernel(Input input, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const bool live = a.mask[b] != 0;
  // a padding frame: its rows are zeroed, or stored by its block
  if (!live && a.flush != gorder::kStore) return;
  const gorder::TypeTable<kShared, kClasses> acc(
      reinterpret_cast<unsigned long long*>(smem), a.out, b, a.n_types);
  if (live) {
    const Escapes esc = input.prologue(
        b, smem + (kShared ? gorder::table_bytes(a.n_types, kClasses) : 0));
    const gorder::MapTable<kClasses> tiles(a.map, a.n_types);
    const float bx = a.box[3 * b], by = a.box[3 * b + 1],
                bz = a.box[3 * b + 2];
    float3 n = make_float3(0.0f, 0.0f, 0.0f);
    if constexpr (!kMolNormal) {
      n = make_float3(a.normal[0], a.normal[1], a.normal[2]);
    }
    const int lane = threadIdx.x & (kWarpSize - 1);
    const int first =
        (static_cast<int>(blockIdx.x) * kWarps + threadIdx.x / kWarpSize) *
        a.chunk;
    const int last = min(first + a.chunk, a.n_bonds);
    int e = esc.seek(3 * first);
    // the same iterations for every lane of the warp: a lane past the
    // chunk, or outside the geometry, adds nothing but takes part
    for (int i0 = first; i0 < last; i0 += kWarpSize) {
      const int i = i0 + lane;
      const bool valid = i < last && inside(a.geo, b, i, a.n_bonds);
      float3 d, pa;
      input(b, i0, i, valid, esc, e, d, pa);
      long long q = 0;
      int t = 0, cls = 0;
      if (valid) {
        if (a.pbc) {
          d = make_float3(min_image(d.x, bx), min_image(d.y, by),
                          min_image(d.z, bz));
        }
        const int mol =
            (kClasses == 3 || kMolNormal) ? a.lf.bond_mol[i] : 0;
        if constexpr (kClasses == 3) {
          cls = gorder::leaflet_class(a.lf.classes, b, a.lf.n_molecules, mol);
        }
        float n2 = 1.0f;
        if constexpr (kMolNormal) {
          n = gorder::molecule_normal(a.normal, b, a.lf.n_molecules, mol);
          n2 = gorder::normal_norm2(n);
        }
        t = a.bond_type[i];
        q = p2_sample<kMolNormal>(d, n, n2);
        if constexpr (Input::kPositions) {
          if (tiles.active()) {
            // the bond midpoint pa + d * 0.5 (gorder_tpu/core/order.py:204)
            tiles.add(tiles.cell(t, __fadd_rn(pa.x, __fmul_rn(d.x, 0.5f)),
                                 __fadd_rn(pa.y, __fmul_rn(d.y, 0.5f)),
                                 __fadd_rn(pa.z, __fmul_rn(d.z, 0.5f))),
                      q, cls);
          }
        }
      }
      acc.add(t, q, valid, cls);
    }
  }
  acc.flush(a.flush);
}

template <class Input, int kClasses, bool kMolNormal>
cudaError_t launch_classes(const Input& input, Args a, int n_frames,
                           cudaStream_t stream) {
  const bool shared = gorder::table_fits(a.n_types, kClasses);
  const gorder::Grid g = gorder::frame_grid(n_frames, a.n_bonds, kThreads);
  a.chunk = g.chunk;
  cudaError_t err = gorder::flush_mode(
      shared, g.splits, 0, a.out,
      static_cast<size_t>(n_frames) * gorder::table_bytes(a.n_types, kClasses),
      stream, &a.flush);
  if (err != cudaSuccess) return err;
  const size_t bytes =
      (shared ? gorder::table_bytes(a.n_types, kClasses) : 0) +
      input.shared_bytes();
  const dim3 grid(g.splits, n_frames);
  if (shared) {
    const auto kernel = p2_kernel<Input, true, kClasses, kMolNormal>;
    if ((err = gorder::allow_shared(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(input, a);
  } else {
    const auto kernel = p2_kernel<Input, false, kClasses, kMolNormal>;
    if ((err = gorder::allow_shared(kernel, bytes)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(input, a);
  }
  return cudaGetLastError();
}

template <class Input>
int launch(const Input& input, const void* box, const void* normal,
           const void* mask, const void* bond_type, const void* classes,
           const void* bond_mol, const void* geo, void* out,
           const gorder::MapGrid& map, int n_frames, int n_bonds,
           int n_types, int pbc, int mol_normals, int n_molecules,
           void* stream) {
  if (n_frames == 0 || n_bonds == 0) return 0;
  const bool by_mol = classes != nullptr || mol_normals != 0;
  if (by_mol != (bond_mol != nullptr) || (by_mol && n_molecules <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (map.state != nullptr &&
      (!Input::kPositions || map.n0 <= 0 || map.n1 <= 0 || map.ax0 < 0 ||
       map.ax0 > 2 || map.ax1 < 0 || map.ax1 > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(box),
               static_cast<const float*>(normal),
               static_cast<const uint8_t*>(mask),
               static_cast<const int32_t*>(bond_type),
               Molecules{static_cast<const int32_t*>(classes),
                         static_cast<const int32_t*>(bond_mol), n_molecules},
               static_cast<const uint8_t*>(geo), map, n_bonds, n_types, pbc,
               0, 0, static_cast<unsigned long long*>(out)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (classes != nullptr) {
    err = mol_normals ? launch_classes<Input, 3, true>(input, a, n_frames, s)
                      : launch_classes<Input, 3, false>(input, a, n_frames, s);
  } else {
    err = mol_normals ? launch_classes<Input, 1, true>(input, a, n_frames, s)
                      : launch_classes<Input, 1, false>(input, a, n_frames, s);
  }
  return static_cast<int>(err);
}

// The integer positions inputs (IntPositions, PairIntPositions) of x.
template <class Input>
int launch_int(const void* x, const void* atom_a, const void* atom_b,
               const void* scale, const void* box, const void* normal,
               const void* mask, const void* bond_type, const void* classes,
               const void* bond_mol, const void* geo, void* out,
               const gorder::MapGrid& map, int n_frames, int n_atoms,
               int n_bonds, int n_types, int pbc, int mol_normals,
               int n_molecules, void* stream) {
  Input input;
  input.x = static_cast<const typename Input::Value*>(x);
  input.atom_a = static_cast<const int32_t*>(atom_a);
  input.atom_b = static_cast<const int32_t*>(atom_b);
  input.scale = static_cast<const float*>(scale);
  input.n_atoms = n_atoms;
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, map, n_frames, n_bonds, n_types, pbc, mol_normals,
                n_molecules, stream);
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream` (with a zeroing of out
// before it when its blocks add with atomics) and returns the first error
// (0 = launched). out (B, 2, T) int64, written whole: no need to zero it;
// classes (B, M) int32 select the with_leaflets variant, out (B, 3, 2, T).
// mol_normals = 1 selects the per_bond_normal variant: normal is then
// (B, M, 3) f32, else (3,). bond_mol (N,) int32 is given exactly when
// classes or per-molecule normals are; n_molecules is their M. The
// positions entry points of ordermap runs (pair int16 and int32, f32)
// take the map by value, its state (C, 2, T * n0 * n1 + 1) int64 with C
// the classes of out, added into; a null state, no map. geo (B, ceil(N/8))
// uint8 is the geometry bitplane (the with_geom variant); null, every bond
// counts.

// The b7 wire as the decoder ships it: pk (B, stride) uint8, gp (B, cap)
// u16 gaps, vl (B, cap) int16, base (3N,) int32, scale (B,) f32;
// cap <= 8192, and stride the whole 7-byte groups of 3N codes.
int p2_b7(const void* pk, const void* gp, const void* vl, const void* base,
          const void* scale, const void* box, const void* normal,
          const void* mask, const void* bond_type, const void* classes,
          const void* bond_mol, const void* geo, void* out, int n_frames,
          int stride, int cap, int n_bonds, int n_types, int pbc,
          int mol_normals, int n_molecules, void* stream) {
  const long long n_values = 3LL * n_bonds;
  if (cap < 0 || cap > kMaxEscapes || n_values > (1LL << 30) ||
      stride != static_cast<int>((n_values + 7) / 8 * 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const B7Input input{static_cast<const uint8_t*>(pk),
                      static_cast<const uint16_t*>(gp),
                      static_cast<const int16_t*>(vl),
                      static_cast<const int32_t*>(base),
                      static_cast<const float*>(scale), stride, cap,
                      static_cast<int>(n_values)};
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, gorder::MapGrid{}, n_frames, n_bonds, n_types, pbc,
                mol_normals, n_molecules, stream);
}

int p2_positions_i16(const void* x, const void* atom_a, const void* atom_b,
                     const void* scale, const void* box, const void* normal,
                     const void* mask, const void* bond_type,
                     const void* classes, const void* bond_mol,
                     const void* geo, void* out, int n_frames, int n_atoms,
                     int n_bonds, int n_types, int pbc, int mol_normals,
                     int n_molecules, void* stream) {
  return launch_int<IntPositions<int16_t>>(
      x, atom_a, atom_b, scale, box, normal, mask, bond_type, classes,
      bond_mol, geo, out, gorder::MapGrid{}, n_frames, n_atoms, n_bonds,
      n_types, pbc, mol_normals, n_molecules, stream);
}

int p2_positions_i16_pair(const void* x, const void* atom_a,
                          const void* atom_b, const void* scale,
                          const void* box, const void* normal,
                          const void* mask, const void* bond_type,
                          const void* classes, const void* bond_mol,
                          const void* geo, void* out, gorder::MapGrid map,
                          int n_frames, int n_atoms, int n_bonds,
                          int n_types, int pbc, int mol_normals,
                          int n_molecules, void* stream) {
  return launch_int<PairIntPositions<int16_t>>(
      x, atom_a, atom_b, scale, box, normal, mask, bond_type, classes,
      bond_mol, geo, out, map, n_frames, n_atoms, n_bonds, n_types, pbc,
      mol_normals, n_molecules, stream);
}

// The s6 and d8 wires: x (B, A, 3) int32 XTC integers; otherwise as
// p2_positions_i16 and p2_positions_i16_pair.
int p2_positions_i32(const void* x, const void* atom_a, const void* atom_b,
                     const void* scale, const void* box, const void* normal,
                     const void* mask, const void* bond_type,
                     const void* classes, const void* bond_mol,
                     const void* geo, void* out, int n_frames, int n_atoms,
                     int n_bonds, int n_types, int pbc, int mol_normals,
                     int n_molecules, void* stream) {
  return launch_int<IntPositions<int32_t>>(
      x, atom_a, atom_b, scale, box, normal, mask, bond_type, classes,
      bond_mol, geo, out, gorder::MapGrid{}, n_frames, n_atoms, n_bonds,
      n_types, pbc, mol_normals, n_molecules, stream);
}

int p2_positions_i32_pair(const void* x, const void* atom_a,
                          const void* atom_b, const void* scale,
                          const void* box, const void* normal,
                          const void* mask, const void* bond_type,
                          const void* classes, const void* bond_mol,
                          const void* geo, void* out, gorder::MapGrid map,
                          int n_frames, int n_atoms, int n_bonds,
                          int n_types, int pbc, int mol_normals,
                          int n_molecules, void* stream) {
  return launch_int<PairIntPositions<int32_t>>(
      x, atom_a, atom_b, scale, box, normal, mask, bond_type, classes,
      bond_mol, geo, out, map, n_frames, n_atoms, n_bonds, n_types, pbc,
      mol_normals, n_molecules, stream);
}

int p2_positions_f32(const void* x, const void* atom_a, const void* atom_b,
                     const void* box, const void* normal, const void* mask,
                     const void* bond_type, const void* classes,
                     const void* bond_mol, const void* geo, void* out,
                     gorder::MapGrid map, int n_frames, int n_atoms,
                     int n_bonds, int n_types, int pbc, int mol_normals,
                     int n_molecules, void* stream) {
  FloatPositions input;
  input.x = static_cast<const float*>(x);
  input.atom_a = static_cast<const int32_t*>(atom_a);
  input.atom_b = static_cast<const int32_t*>(atom_b);
  input.n_atoms = n_atoms;
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, map, n_frames, n_bonds, n_types, pbc, mol_normals,
                n_molecules, stream);
}

// The message of a code that an entry point of this library returned.
const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

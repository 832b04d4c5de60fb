// United-atom order-parameter kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gorder_tpu/ops/pallas_ua.py `_ua_kernel` (built
// by `make_pallas_ua_step`), for a static membrane normal or per-molecule
// normals (`per_bond_normal`, below), with and without leaflet classes
// (`with_leaflets`: the class plane gathered at pallas_ua.py:253-258, the
// masks at :120-122), on int16 or int32 XTC positions with a per-frame
// scale or on f32 positions. It computes what the JAX package's XLA path
// computes (gorder_tpu/core/ua.py `_ua_step_impl` with the planar
// predictors at :145-226), not the TPU kernel's acos-free CH1u variant,
// which exists only because Mosaic has no acos.
//
// One thread per (frame, target carbon) of one category:
//   1. gather the target and its 2-3 helper atoms, dequantized
//      f32(q) * s on the integer inputs;
//   2. the min-imaged helper differences;
//   3. the buildH prediction of the category's K hydrogens (CH3 K = 3,
//      CH2 K = 2, CH1-unsaturated and CH1-saturated K = 1;
//      src/analysis/uaorder.rs:944-1106);
//   4. per hydrogen: wrap into the box (floor), the C-H vector, its
//      minimum image (rint), proj = (vx*nx + vy*ny) + vz*nz,
//      d2 = max(v.v, 1e-18), S = (1.5*proj^2)/d2 - 0.5, and the fixed-point
//      sample q = llround(f64(S) * 1e6);
//   5. per hydrogen k, the warp's samples into the block's (2, T) int64
//      table at each sample's type (sample = category offset + i*K + k),
//      aggregated per type over the warp (common.cuh TypeTable).
//      with_leaflets: the table is (3, 2, T) and the carbon's class
//      classes[b, mol[i]] picks upper or lower beside total, from the
//      per-carbon molecule index that the compiled UA topology carries
//      (pallas_ua.py:179-183).
// Every f32 add, multiply and divide is an _rn intrinsic, grouped as the
// planar JAX formulation groups it, so nothing is contracted into an FMA;
// sqrtf (with -prec-sqrt=true), atan2f, cosf and sinf are the accurate CUDA
// math-library functions that torch's CUDA sqrt/atan2/cos/sin call. The
// integers therefore equal the plain PyTorch version's on the card
// (gorder_tpu_torch/core/ua.py ua_step) bit for bit. As in that version,
// gamma = acos(x) is written the way XLA compiles jnp.arccos,
// atan2(sqrt((1 - x)*(x + 1)), x), and the cos/sin of the constant angles
// are the f32 values XLA folds them to, passed in by value by the wrapper.
//
// The TPU kernel reads pre-gathered (B, n) planes per coordinate and sums
// 7-bit limbs with one-hot matmuls on the MXU. Here each thread gathers its
// own atoms and sums in int64, exact in any order. What bounds it on this
// card: the operations, about 100-200 f32 operations plus one or two
// accurate transcendentals (sqrt; atan2, cos, sin for CH1u) a sample,
// against the gather of 3-4 atoms x 6 bytes a target on the int16 input
// (12 bytes on int32 and f32). What the design does about it:
//   - the targets are laid out type-major (topology/ua.py: for each
//     carbon, that carbon of every molecule), so the 32 lanes of a warp
//     hold one carbon and, for each k, one sample type: the per-type sums
//     are warp-aggregated (common.cuh TypeTable), one add per warp and k
//     instead of 32 serialized shared atomics on one address, which made
//     the samples' add cost several times their arithmetic;
//   - a block owns one frame and each warp a contiguous chunk of the
//     category's targets, so that the first category's launch stores the
//     frame's rows of the type table and the later ones add to them with
//     plain loads and stores: no global atomics and no zeroing. With fewer
//     frames than twice the SMs, a frame is split over several blocks,
//     which add with global atomics (into an output the first launch zeroes
//     on the stream);
//   - consecutive lanes take the same carbon of consecutive molecules, so a
//     warp's gathers are strided by a molecule's atoms: what the warp reads
//     of a frame it reads once, from L1/L2.

// Ordermaps (every category x input, with and without classes and
// normals): the TPU kernel has no map variant (pallas_ua.py:60-61 refuses
// maps) and the JAX package runs UA map runs through XLA, scattering the
// samples with segment_sum (gorder_tpu/core/ua.py:302-306, :354-357).
// Here the thread that computes a sample also adds it to the ordermap
// state at the tile of its bond position h + v*0.5 (h wrapped, v the
// min-imaged C-H vector when PBC is on), with two 64-bit global atomics
// per class (common.cuh MapTable); a null state pointer is a uniform
// branch. What bounds it: those atomics into a table of T * n0 * n1
// entries per row (0.59 M for the UA membrane at 0.1 nm) and about 14 f32
// operations per sample.
//
// per_bond_normal (kMolNormal; replaces pallas_ua.py:110-113 and :136-141
// with the operand gather at :234-240): dynamic or manual membrane
// normals, (B, M, 3) f32, one per molecule and frame. Each thread reads
// its carbon's molecule's normal n = normal[(b*M + mol[i])*3 ..] once,
// n2 = max((nx*nx + ny*ny) + nz*nz, 1e-18), and per hydrogen
// proj = (vx*nx + vy*ny) + vz*nz and S = (1.5*proj^2) / (d2*n2) - 0.5
// (gorder_tpu/core/ua.py:282-301), grouped otherwise than the P2 kernel's
// cos2. With n = (0, 0, 1) that is the static chain bit for bit. The TPU
// wrapper gathers (B, n, 3) per-carbon normal planes in HBM before its
// pallas_call; here the kernel reads the (B, M, 3) tensor, whose 3 KB
// frame row stays in L1/L2. It combines with the class plane (both read
// mol). What bounds it: 12 more bytes gathered per carbon (from cache; the
// bytes the function must move are the normals once, 12 * M per frame),
// 6 f32 operations per carbon and 1 per hydrogen more, and the same
// warp-aggregated adds.

// Geometry selection (GeoShape; every category x input, with and without
// classes, normals and a map): the TPU kernel has no geometry variant
// (pallas_ua.py:60-61 refuses it) and the JAX package runs UA geometry
// runs through XLA (gorder_tpu/core/ua.py:302-333): the inside test of
// each sample's bond position h + v*0.5 against the frame's reference
// point. That position exists only inside this kernel, so the test is
// made here, on the position the map output also reads
// (common.cuh geo_inside); the (B, 3) f32 reference of each frame (a fixed
// point, the box center, or a selection's center) is computed outside. A
// sample outside the shape adds nothing to the sums, the counts or the
// map, but its lane stays in the warp's add. A null reference is a
// uniform branch. What bounds it: 12 bytes of
// reference a frame and about 15-25 f32 operations a sample.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// cos/sin of TETRAHEDRAL_ANGLE, TETRAHEDRAL_ANGLE_HALF and CH3_ANGLE as XLA
// folds them (core/ua.py TRIG); passed by value from ctypes
struct Trig {
  float cos_tet, sin_tet, cos_half, sin_half, cos_ch3, sin_ch3;
};

namespace {

using gorder::kWarpSize;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarpSize;
constexpr float kBondLength = 0.109f;    // f32(0.109), core/ua.py
constexpr float kPi = 3.14159265358979f;  // f32(pi), as jnp.pi - x takes it

enum Category { kCH3 = 0, kCH2 = 1, kCH1U = 2, kCH1S = 3 };

__host__ __device__ constexpr int n_hydrogens(int c) {
  return c == kCH3 ? 3 : (c == kCH2 ? 2 : 1);
}

struct V {
  float x, y, z;
};

__device__ __forceinline__ V vsub(V a, V b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

// (x + y) + z: jnp.sum's order over a size-3 axis (core/ua.py _pdot)
__device__ __forceinline__ float vdot(V a, V b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ V vcross(V a, V b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

// v / sqrt(max(v.v, 1e-30)): a division, not a reciprocal product
__device__ __forceinline__ V vnormalize(V v) {
  const float n = sqrtf(fmaxf(vdot(v, v), 1e-30f));
  return {__fdiv_rn(v.x, n), __fdiv_rn(v.y, n), __fdiv_rn(v.z, n)};
}

__device__ __forceinline__ V vmin_image(V d, V box) {
  return {gorder::min_image(d.x, box.x), gorder::min_image(d.y, box.y),
          gorder::min_image(d.z, box.z)};
}

// x - L*floor(x/L)
__device__ __forceinline__ float wrap(float x, float box) {
  return __fsub_rn(x, __fmul_rn(box, floorf(__fdiv_rn(x, box))));
}

// (v*c + (k x v)*s) + (k*(k.v))*(1 - c)
__device__ __forceinline__ V rodrigues(V v, V k, float c, float s) {
  const V kc = vcross(k, v);
  const float kdv = vdot(k, v);
  const float one_m = __fsub_rn(1.0f, c);
  return {__fadd_rn(__fadd_rn(__fmul_rn(v.x, c), __fmul_rn(kc.x, s)),
                    __fmul_rn(__fmul_rn(k.x, kdv), one_m)),
          __fadd_rn(__fadd_rn(__fmul_rn(v.y, c), __fmul_rn(kc.y, s)),
                    __fmul_rn(__fmul_rn(k.y, kdv), one_m)),
          __fadd_rn(__fadd_rn(__fmul_rn(v.z, c), __fmul_rn(kc.z, s)),
                    __fmul_rn(__fmul_rn(k.z, kdv), one_m))};
}

// t + normalize(hv) * BOND_LENGTH
__device__ __forceinline__ V add_bond(V t, V hv) {
  const V u = vnormalize(hv);
  return {__fadd_rn(t.x, __fmul_rn(u.x, kBondLength)),
          __fadd_rn(t.y, __fmul_rn(u.y, kBondLength)),
          __fadd_rn(t.z, __fmul_rn(u.z, kBondLength))};
}

// The category's K hydrogen positions from the target t and helpers a1-a3
// (core/ua.py predict_*_planar).
template <int C>
__device__ __forceinline__ void predict(V t, V a1, V a2, V a3, V box,
                                        bool pbc, const Trig& g, V* h) {
  V th1 = vsub(a1, t);
  V th2 = vsub(a2, t);
  if (pbc) {
    th1 = vmin_image(th1, box);
    th2 = vmin_image(th2, box);
  }
  if constexpr (C == kCH3) {
    const V axis1 = vnormalize(vcross(th2, th1));
    const V hv1 = rodrigues(th1, axis1, g.cos_tet, g.sin_tet);
    const V axis2 = vnormalize(th1);
    h[0] = add_bond(t, hv1);
    h[1] = add_bond(t, rodrigues(hv1, axis2, g.cos_ch3, g.sin_ch3));
    h[2] = add_bond(t, rodrigues(hv1, axis2, g.cos_ch3, -g.sin_ch3));
  } else if constexpr (C == kCH2) {
    const V u1 = vnormalize(th1);
    const V u2 = vnormalize(th2);
    const V plane_normal = vcross(u2, u1);
    const V rot_axis = vnormalize(vsub(u1, u2));
    const V rot_vec = vcross(plane_normal, rot_axis);
    h[0] = add_bond(t, rodrigues(rot_vec, rot_axis, g.cos_half, g.sin_half));
    h[1] = add_bond(t, rodrigues(rot_vec, rot_axis, g.cos_half, -g.sin_half));
  } else if constexpr (C == kCH1U) {
    const float dot = vdot(th1, th2);
    const float norms = sqrtf(__fmul_rn(vdot(th1, th1), vdot(th2, th2)));
    const float x =
        fminf(fmaxf(__fdiv_rn(dot, fmaxf(norms, 1e-30f)), -1.0f), 1.0f);
    // jnp.arccos(x) as XLA compiles it
    const float gamma =
        atan2f(sqrtf(__fmul_rn(__fsub_rn(1.0f, x), __fadd_rn(x, 1.0f))), x);
    const V axis = vnormalize(vcross(th1, th2));
    const float angle = __fsub_rn(kPi, __fmul_rn(gamma, 0.5f));
    h[0] = add_bond(t, rodrigues(th2, axis, cosf(angle), sinf(angle)));
  } else {  // kCH1S
    V th3 = vsub(a3, t);
    if (pbc) th3 = vmin_image(th3, box);
    const V n1 = vnormalize(th1);
    const V n2 = vnormalize(th2);
    const V n3 = vnormalize(th3);
    const V hv = {-__fadd_rn(__fadd_rn(n1.x, n2.x), n3.x),
                  -__fadd_rn(__fadd_rn(n1.y, n2.y), n3.y),
                  -__fadd_rn(__fadd_rn(n1.z, n2.z), n3.z)};
    h[0] = add_bond(t, hv);
  }
}

// The C-H vector of hydrogen h on target t: with PBC, h is wrapped into
// the box (in place: the map's bond position reads it) and the vector
// min-imaged.
__device__ __forceinline__ V ch_vector(V& h, V t, V box, bool pbc) {
  if (pbc) h = {wrap(h.x, box.x), wrap(h.y, box.y), wrap(h.z, box.z)};
  const V vec = vsub(h, t);
  return pbc ? vmin_image(vec, box) : vec;
}

// One C-H sample of the vector vec against the normal n: the static one,
// or (kMolNormal) the molecule's, with n2 = max(n.n, 1e-18).
template <bool kMolNormal>
__device__ __forceinline__ long long ua_sample(V vec, V n, float n2) {
  const float proj = __fadd_rn(
      __fadd_rn(__fmul_rn(vec.x, n.x), __fmul_rn(vec.y, n.y)),
      __fmul_rn(vec.z, n.z));
  const float d2 = fmaxf(vdot(vec, vec), 1e-18f);
  const float den = kMolNormal ? __fmul_rn(d2, n2) : d2;
  const float sch =
      __fsub_rn(__fdiv_rn(__fmul_rn(1.5f, __fmul_rn(proj, proj)), den), 0.5f);
  return gorder::quantum(sch);
}

// Integer input: x (B, A, 3) XTC integers, int16 (the i16 and i12 wires)
// or int32 (s6 and d8; pallas_ua.py:202-203 takes either), scale (B,) f32:
// p = f32(q) * s, __int2float_rn exact for |q| < 2^24 (16,777 nm at
// precision 1000). The int32 input gathers 12 bytes an atom against 6.
template <class T>
struct IntCoords {
  const T* __restrict__ x;
  const float* __restrict__ scale;
  int n_atoms;
  __device__ __forceinline__ V operator()(int b, int a) const {
    const T* p = x + (static_cast<size_t>(b) * n_atoms + a) * 3;
    const float s = scale[b];
    return {__fmul_rn(__int2float_rn(p[0]), s),
            __fmul_rn(__int2float_rn(p[1]), s),
            __fmul_rn(__int2float_rn(p[2]), s)};
  }
};

// f32 input: x (B, A, 3) positions.
struct FloatCoords {
  const float* __restrict__ x;
  int n_atoms;
  __device__ __forceinline__ V operator()(int b, int a) const {
    const float* p = x + (static_cast<size_t>(b) * n_atoms + a) * 3;
    return {p[0], p[1], p[2]};
  }
};

struct Targets {
  const int32_t* __restrict__ target;
  const int32_t* __restrict__ h1;
  const int32_t* __restrict__ h2;
  const int32_t* __restrict__ h3;  // CH1s only
  const int32_t* __restrict__ mol;  // with_leaflets or per_bond_normal
  const int32_t* __restrict__ bond_type;  // this category's samples
  int n_cat;
};

// grid (splits, B): block (s, b) takes frame b's targets
// [s * kWarps * chunk, (s + 1) * kWarps * chunk), a chunk a warp;
// out (B, kClasses, 2, T) int64, reached by `flush` (gorder::Flush);
// classes (B, M) int32 when kClasses == 3; normal (3,) f32, or
// (B, M, 3) f32 when kMolNormal; map: the ordermap, added into (state
// null without one); shape and ref (B, 3) f32: the geometry and its
// reference points (ref null without one).
template <int C, class Coords, bool kShared, int kClasses, bool kMolNormal>
__global__ void __launch_bounds__(kThreads)
ua_kernel(Coords coords, Targets tg, const float* __restrict__ box,
          const float* __restrict__ normal, Trig g,
          const uint8_t* __restrict__ mask,
          const int32_t* __restrict__ classes, gorder::MapGrid map,
          gorder::GeoShape shape, const float* __restrict__ ref,
          int n_molecules, int n_types, int pbc, int chunk, int flush,
          unsigned long long* __restrict__ out) {
  constexpr int K = n_hydrogens(C);
  extern __shared__ unsigned long long table[];  // when kShared
  const int b = blockIdx.y;
  const bool live = mask[b] != 0;
  // a padding frame: its rows are zeroed, or stored by its block
  if (!live && flush != gorder::kStore) return;
  const gorder::TypeTable<kShared, kClasses> acc(table, out, b, n_types);
  if (live) {
    const gorder::MapTable<kClasses> tiles(map, n_types);
    const V L = {box[3 * b], box[3 * b + 1], box[3 * b + 2]};
    const float3 ref_b = ref != nullptr
                             ? make_float3(ref[3 * b], ref[3 * b + 1],
                                           ref[3 * b + 2])
                             : make_float3(0.0f, 0.0f, 0.0f);
    V n = {0.0f, 0.0f, 0.0f};
    if constexpr (!kMolNormal) n = {normal[0], normal[1], normal[2]};
    const int first =
        (static_cast<int>(blockIdx.x) * kWarps + threadIdx.x / kWarpSize) *
        chunk;
    const int last = min(first + chunk, tg.n_cat);
    // the same iterations for every lane of the warp: a lane past the
    // chunk, or a hydrogen outside the geometry, adds nothing but takes
    // part in the warp's add of each hydrogen k
    for (int i0 = first; i0 < last; i0 += kWarpSize) {
      const int i = i0 + static_cast<int>(threadIdx.x & (kWarpSize - 1));
      const bool in = i < last;
      V t = {0.0f, 0.0f, 0.0f};
      V h[K];
      int cls = 0;
      float n2 = 1.0f;
      if (in) {
        t = coords(b, tg.target[i]);
        const V a1 = coords(b, tg.h1[i]);
        const V a2 = coords(b, tg.h2[i]);
        const V a3 = C == kCH1S ? coords(b, tg.h3[i]) : V{0.0f, 0.0f, 0.0f};
        if constexpr (kClasses == 3) {
          cls = gorder::leaflet_class(classes, b, n_molecules, tg.mol[i]);
        }
        if constexpr (kMolNormal) {
          const float3 nm =
              gorder::molecule_normal(normal, b, n_molecules, tg.mol[i]);
          n = {nm.x, nm.y, nm.z};
          n2 = gorder::normal_norm2(nm);
        }
        predict<C>(t, a1, a2, a3, L, pbc != 0, g, h);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        bool valid = in;
        long long q = 0;
        int type = 0;
        if (in) {
          const V vec = ch_vector(h[k], t, L, pbc != 0);
          // the bond position h + vec * 0.5 (gorder_tpu/core/ua.py:302-306)
          const float3 pos =
              make_float3(__fadd_rn(h[k].x, __fmul_rn(vec.x, 0.5f)),
                          __fadd_rn(h[k].y, __fmul_rn(vec.y, 0.5f)),
                          __fadd_rn(h[k].z, __fmul_rn(vec.z, 0.5f)));
          // outside the geometry: counts nowhere
          valid = ref == nullptr ||
                  gorder::geo_inside(shape, pos, ref_b,
                                     make_float3(L.x, L.y, L.z), pbc != 0);
          if (valid) {
            type = tg.bond_type[i * K + k];
            q = ua_sample<kMolNormal>(vec, n, n2);
            if (tiles.active()) {
              tiles.add(tiles.cell(type, pos.x, pos.y, pos.z), q, cls);
            }
          }
        }
        acc.add(type, q, valid, cls);
      }
    }
  }
  acc.flush(flush);
}

// What one category's launch shares with the others of a call.
struct Launch {
  const float* box;
  const float* normal;
  Trig trig;
  const uint8_t* mask;
  const int32_t* classes;
  gorder::MapGrid map;
  gorder::GeoShape shape;
  const float* ref;
  int n_molecules, n_frames, n_types, pbc, accumulate;
  unsigned long long* out;
  cudaStream_t stream;
};

template <int C, class Coords, int kClasses, bool kMolNormal>
cudaError_t launch_table(const Coords& coords, const Targets& tg,
                         const Launch& l) {
  const bool shared = gorder::table_fits(l.n_types, kClasses);
  const gorder::Grid grid =
      gorder::frame_grid(l.n_frames, tg.n_cat, kThreads);
  int flush = 0;
  cudaError_t err = gorder::flush_mode(
      shared, grid.splits, l.accumulate, l.out,
      static_cast<size_t>(l.n_frames) * gorder::table_bytes(l.n_types,
                                                            kClasses),
      l.stream, &flush);
  if (err != cudaSuccess) return err;
  const dim3 blocks(grid.splits, l.n_frames);
  if (shared) {
    ua_kernel<C, Coords, true, kClasses, kMolNormal>
        <<<blocks, kThreads, gorder::table_bytes(l.n_types, kClasses),
           l.stream>>>(coords, tg, l.box, l.normal, l.trig, l.mask,
                       l.classes, l.map, l.shape, l.ref, l.n_molecules,
                       l.n_types, l.pbc, grid.chunk, flush, l.out);
  } else {
    ua_kernel<C, Coords, false, kClasses, kMolNormal>
        <<<blocks, kThreads, 0, l.stream>>>(
            coords, tg, l.box, l.normal, l.trig, l.mask, l.classes, l.map,
            l.shape, l.ref, l.n_molecules, l.n_types, l.pbc, grid.chunk,
            flush, l.out);
  }
  return cudaGetLastError();
}

template <int C, class Coords>
cudaError_t launch_category(const Coords& coords, const Targets& tg,
                            const Launch& l, int mol_normals) {
  if (l.classes != nullptr) {
    return mol_normals ? launch_table<C, Coords, 3, true>(coords, tg, l)
                       : launch_table<C, Coords, 3, false>(coords, tg, l);
  }
  return mol_normals ? launch_table<C, Coords, 1, true>(coords, tg, l)
                     : launch_table<C, Coords, 1, false>(coords, tg, l);
}

template <class Coords>
int launch(int category, const Coords& coords, const void* target,
           const void* h1, const void* h2, const void* h3, const void* mol,
           const void* bond_type, const void* box, const void* normal,
           const Trig& trig, const void* mask, const void* classes,
           void* out, const gorder::MapGrid& map,
           const gorder::GeoShape& shape, const void* ref, int n_frames,
           int n_cat, int n_types, int pbc, int mol_normals, int n_molecules,
           int accumulate, void* stream) {
  if (n_frames == 0 || n_cat == 0) return 0;
  if ((classes != nullptr || mol_normals != 0) &&
      (mol == nullptr || n_molecules <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (map.state != nullptr &&
      (map.n0 <= 0 || map.n1 <= 0 || map.ax0 < 0 || map.ax0 > 2 ||
       map.ax1 < 0 || map.ax1 > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((ref != nullptr) != (shape.kind >= 0) || shape.kind > 2 ||
      shape.orientation < 0 || shape.orientation > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Targets tg{static_cast<const int32_t*>(target),
                   static_cast<const int32_t*>(h1),
                   static_cast<const int32_t*>(h2),
                   static_cast<const int32_t*>(h3),
                   static_cast<const int32_t*>(mol),
                   static_cast<const int32_t*>(bond_type), n_cat};
  const Launch l{static_cast<const float*>(box),
                 static_cast<const float*>(normal),
                 trig,
                 static_cast<const uint8_t*>(mask),
                 static_cast<const int32_t*>(classes),
                 map,
                 shape,
                 static_cast<const float*>(ref),
                 n_molecules,
                 n_frames,
                 n_types,
                 pbc,
                 accumulate,
                 static_cast<unsigned long long*>(out),
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (category) {
    case kCH3:
      err = launch_category<kCH3>(coords, tg, l, mol_normals);
      break;
    case kCH2:
      err = launch_category<kCH2>(coords, tg, l, mol_normals);
      break;
    case kCH1U:
      err = launch_category<kCH1U>(coords, tg, l, mol_normals);
      break;
    case kCH1S:
      if (h3 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_category<kCH1S>(coords, tg, l, mol_normals);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch for one category (0 CH3, 1 CH2,
// 2 CH1u, 3 CH1s) on `stream` and returns the first error (0 =
// launched). accumulate = 0 writes out whole (the first category of a
// call: no need to zero it), 1 adds into it (the later ones). h3 is null
// except for CH1s; bond_type points at the category's first sample.
// classes (B, M) int32 with the category's per-carbon molecules mol select
// the with_leaflets variant, out (B, 3, 2, T); classes null, the plain
// one, out (B, 2, T). mol_normals = 1 selects the per_bond_normal variant:
// normal is then (B, M, 3) f32 read by mol, else (3,); n_molecules is M.
// map: the ordermap by value, its state (C, 2, T * n0 * n1 + 1) int64 with
// C the classes of out, added into; a null state, no map. shape: the
// geometry by value, with ref (B, 3) f32 its reference point per frame; a
// null ref (and shape.kind -1), no geometry.

int ua_positions_i16(int category, const void* x, const void* scale,
                     const void* target, const void* h1, const void* h2,
                     const void* h3, const void* mol, const void* bond_type,
                     const void* box, const void* normal, Trig trig,
                     const void* mask, const void* classes, void* out,
                     gorder::MapGrid map, gorder::GeoShape shape,
                     const void* ref, int n_frames, int n_atoms, int n_cat,
                     int n_types, int pbc, int mol_normals, int n_molecules,
                     int accumulate, void* stream) {
  const IntCoords<int16_t> coords{static_cast<const int16_t*>(x),
                                  static_cast<const float*>(scale), n_atoms};
  return launch(category, coords, target, h1, h2, h3, mol, bond_type, box,
                normal, trig, mask, classes, out, map, shape, ref, n_frames,
                n_cat, n_types, pbc, mol_normals, n_molecules, accumulate,
                stream);
}

// The s6 and d8 wires: x (B, A, 3) int32 XTC integers; otherwise as
// ua_positions_i16.
int ua_positions_i32(int category, const void* x, const void* scale,
                     const void* target, const void* h1, const void* h2,
                     const void* h3, const void* mol, const void* bond_type,
                     const void* box, const void* normal, Trig trig,
                     const void* mask, const void* classes, void* out,
                     gorder::MapGrid map, gorder::GeoShape shape,
                     const void* ref, int n_frames, int n_atoms, int n_cat,
                     int n_types, int pbc, int mol_normals, int n_molecules,
                     int accumulate, void* stream) {
  const IntCoords<int32_t> coords{static_cast<const int32_t*>(x),
                                  static_cast<const float*>(scale), n_atoms};
  return launch(category, coords, target, h1, h2, h3, mol, bond_type, box,
                normal, trig, mask, classes, out, map, shape, ref, n_frames,
                n_cat, n_types, pbc, mol_normals, n_molecules, accumulate,
                stream);
}

int ua_positions_f32(int category, const void* x, const void* target,
                     const void* h1, const void* h2, const void* h3,
                     const void* mol, const void* bond_type, const void* box,
                     const void* normal, Trig trig, const void* mask,
                     const void* classes, void* out, gorder::MapGrid map,
                     gorder::GeoShape shape, const void* ref, int n_frames,
                     int n_atoms, int n_cat, int n_types, int pbc,
                     int mol_normals, int n_molecules, int accumulate,
                     void* stream) {
  const FloatCoords coords{static_cast<const float*>(x), n_atoms};
  return launch(category, coords, target, h1, h2, h3, mol, bond_type, box,
                normal, trig, mask, classes, out, map, shape, ref, n_frames,
                n_cat, n_types, pbc, mol_normals, n_molecules, accumulate,
                stream);
}

}  // extern "C"

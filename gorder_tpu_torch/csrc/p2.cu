// P2 order-parameter kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gorder_tpu/ops/pallas_p2.py `_p2_kernel` (with
// its tile math `_p2_limbs` and reduction `_accumulate`), in its
// `resid_input` variant (b7 wire) and its positions variants (the
// single-rounding integer difference and the f32 pair difference), each
// with and without `with_leaflets` (the class plane gathered at
// pallas_p2.py:393-400, the masks at :220-222).
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
// atomics. Here q is summed directly in int64: each block owns one frame
// and a range of kTile bonds, adds its samples into a (2, T) int64 table in
// shared memory with 64-bit shared atomics, then adds each nonzero entry
// to the (B, 2, T) output with one global atomic. Integer sums are exact in
// any order, so the result is deterministic. When 2*T int64 do not fit in
// the default 48 KiB of shared memory (T > 3072), the kernel adds straight
// into the output with global atomics instead.
//
// with_leaflets: the (B, M) int32 class plane and each bond's molecule
// bond_mol (N,) int32 give the sample's class cls = classes[b, bond_mol[i]];
// the table becomes (3, 2, T) -- total, upper (cls 0), lower (cls 1) --
// and the output (B, 3, 2, T). The table then fits shared memory only for
// T <= 1024; above that the kernel adds into the output with global
// atomics. The class costs one more 4-byte gather per sample (the plane
// row of a frame is M * 4 bytes and stays in L1/L2) and up to two more
// atomics.
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
// normals once, 12 * M per frame), about 8 more f32 operations, and the
// same int64 shared atomics as the static variant. This first version is
// plain: making it fast is later work.
//
// pair_quantized (PairIntPositions; replaces pallas_p2.py:287-304): int16
// positions of an ordermap run take the pair difference of the dequantized
// positions, d = f32(q_b)*s - f32(q_a)*s, the reference's f32-position
// arithmetic, instead of the single rounding f32(q_b - q_a)*s: map-bin
// boundaries are sensitive to the last ulp, and XTC positions at precision
// 1000 put many bond midpoints exactly on a 0.1 nm boundary. The type sums
// take the same d (gorder_tpu/core/order.py:144-162).
//
// Ordermaps (the positions inputs, pair int16 and f32; with and without
// classes and per-molecule normals): the JAX package computes each sample
// twice, once in the Pallas kernel for the type sums and once in XLA for
// the map (core/order.py `_map_only_impl`, a segment_sum of 7-bit f32
// limbs added up on the host every batch). Here the thread that computes a
// sample adds it to its map cell too, with two 64-bit global atomics per
// class (common.cuh MapTable): the cell of the bond midpoint pa + d*0.5
// after the minimum image (core/order.py:204). The map is one int64 state
// on the device for the whole run, exact in any order. A null state
// pointer is a uniform branch, not another template axis. What bounds it:
// the map adds 2 (4 with classes) global atomics per sample into a table
// of T * n0 * n1 entries per row (1.3 M for the AA membrane at 0.1 nm, 21
// MB a class: above the 50 MB L2 with classes), and about 14 f32
// operations. This first version is plain.
//
// with_geom (replaces pallas_p2.py:204-206 and :218-219, with the plane
// built at :384-391) and diff_input (:276-286): a geometry selection keeps
// only the samples whose bond midpoint lies inside the shape. The TPU
// kernel multiplies a (B, N) f32 inside plane into the mask of every
// accumulator; here every entry point takes the (B, ceil(N/8)) uint8
// bitplane `geo` (bit i & 7 of byte i >> 3 is bond i), the layout in which
// the XTC decoder evaluates it host-side (native/xdr.cpp xtc_geo_mask,
// the b7geo wire and the coordinate wires' *G kinds) and in which the
// device-computed mask is packed (engine/wire.py pack_geo_bits). A thread
// whose bond bit is 0 adds nothing to the type sums, the counts or the
// map. A null `geo` is a uniform branch, not another template axis.
// diff_input is the TPU kernel's input of bond vectors (the b7 wires
// dequantized outside the kernel); the b7geo wire hands this kernel its
// residuals instead, and p2_resid rebuilds the same f32(base + r) * s in
// registers (:192-197), so diff_input needs no entry point of its own.
// What bounds it: 1/8 byte a bond more, against the TPU kernel's 4-byte
// f32 plane; a sample outside the shape costs the bit test only.
//
// What bounds it on this card: it reads about 2 bytes of b7 residual per
// value (6 per sample) plus the per-slot base, and does two 64-bit atomic
// adds per sample; arithmetic is a few dozen flops. Memory and atomics
// bound it, far below the card's compute rate.
//
// Later work: fusing the b7 unpack (gorder_tpu_torch/engine/wire.py) into
// this kernel's prologue, TMA loads of the residual tiles, and wgmma are
// for later changes; this first version is plain and right.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using gorder::min_image;

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 8;      // bonds per block

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

// Each input gives sample (b, i)'s bond vector d and, when kPositions, the
// f32 position pa of its first atom (the map's midpoint reads it).

// b7 wire: r (B, 3N) int16 interleaved (slot = bond*3 + c), base (3N,)
// int32, scale (B,) f32: d = f32(base + r) * s.
struct ResidInput {
  static constexpr bool kPositions = false;
  const int16_t* __restrict__ r;
  const int32_t* __restrict__ base;
  const float* __restrict__ scale;
  int n_values;  // 3N
  __device__ __forceinline__ void operator()(int b, int i, float3& d,
                                             float3&) const {
    const int16_t* rb = r + static_cast<size_t>(b) * n_values + 3 * i;
    const int32_t* bs = base + 3 * i;
    const float s = scale[b];
    d = make_float3(__fmul_rn(__int2float_rn(bs[0] + rb[0]), s),
                    __fmul_rn(__int2float_rn(bs[1] + rb[1]), s),
                    __fmul_rn(__int2float_rn(bs[2] + rb[2]), s));
  }
};

// i16 wire: x (B, A, 3) int16 XTC integers, scale (B,) f32:
// d = f32(q_b - q_a) * s, the single rounding of the exact difference.
struct IntPositions {
  static constexpr bool kPositions = false;
  const int16_t* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  const float* __restrict__ scale;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int i, float3& d,
                                             float3&) const {
    const int16_t* xb = x + static_cast<size_t>(b) * n_atoms * 3;
    const int16_t* pa = xb + 3 * atom_a[i];
    const int16_t* pb = xb + 3 * atom_b[i];
    const float s = scale[b];
    d = make_float3(__fmul_rn(__int2float_rn(int(pb[0]) - int(pa[0])), s),
                    __fmul_rn(__int2float_rn(int(pb[1]) - int(pa[1])), s),
                    __fmul_rn(__int2float_rn(int(pb[2]) - int(pa[2])), s));
  }
};

// i16 wire of an ordermap run (pair_quantized): the positions dequantized
// first, p = f32(q) * s, then d = p_b - p_a.
struct PairIntPositions {
  static constexpr bool kPositions = true;
  const int16_t* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  const float* __restrict__ scale;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int i, float3& d,
                                             float3& pa) const {
    const int16_t* xb = x + static_cast<size_t>(b) * n_atoms * 3;
    const int16_t* qa = xb + 3 * atom_a[i];
    const int16_t* qb = xb + 3 * atom_b[i];
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
struct FloatPositions {
  static constexpr bool kPositions = true;
  const float* __restrict__ x;
  const int32_t* __restrict__ atom_a;
  const int32_t* __restrict__ atom_b;
  int n_atoms;
  __device__ __forceinline__ void operator()(int b, int i, float3& d,
                                             float3& pa) const {
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

// grid (ceil(N / kTile), B); out (B, kClasses, 2, T) int64, zeroed by the
// caller; normal (3,) f32, or (B, M, 3) f32 when kMolNormal; geo: the
// geometry bitplane (null without one); map: the ordermap, added into
// (positions inputs only; state null without one).
template <class Input, bool kShared, int kClasses, bool kMolNormal>
__global__ void __launch_bounds__(kThreads)
p2_kernel(Input input, const float* __restrict__ box,
          const float* __restrict__ normal, const uint8_t* __restrict__ mask,
          const int32_t* __restrict__ bond_type, Molecules lf,
          const uint8_t* __restrict__ geo, gorder::MapGrid map, int n_bonds,
          int n_types, int pbc, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long table[];  // when kShared
  const int b = blockIdx.y;
  if (!mask[b]) return;  // padding frame: its rows stay zero
  const gorder::TypeTable<kShared, kClasses> acc(table, out, b, n_types);
  const gorder::MapTable<kClasses> tiles(map, n_types);
  const float bx = box[3 * b], by = box[3 * b + 1], bz = box[3 * b + 2];
  float3 n = make_float3(0.0f, 0.0f, 0.0f);
  if constexpr (!kMolNormal) n = make_float3(normal[0], normal[1], normal[2]);
  const int start = static_cast<int>(blockIdx.x) * kTile;
  const int stop = min(start + kTile, n_bonds);
  for (int i = start + static_cast<int>(threadIdx.x); i < stop;
       i += kThreads) {
    if (!inside(geo, b, i, n_bonds)) continue;
    float3 d, pa;
    input(b, i, d, pa);
    if (pbc) {
      d = make_float3(min_image(d.x, bx), min_image(d.y, by),
                      min_image(d.z, bz));
    }
    const int mol = (kClasses == 3 || kMolNormal) ? lf.bond_mol[i] : 0;
    const int cls =
        kClasses == 3
            ? gorder::leaflet_class(lf.classes, b, lf.n_molecules, mol)
            : 0;
    float n2 = 1.0f;
    if constexpr (kMolNormal) {
      n = gorder::molecule_normal(normal, b, lf.n_molecules, mol);
      n2 = gorder::normal_norm2(n);
    }
    const int t = bond_type[i];
    const long long q = p2_sample<kMolNormal>(d, n, n2);
    acc.add(t, q, cls);
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
  acc.flush();
}

// What every launch of one entry point shares.
struct Launch {
  dim3 grid;
  const float* box;
  const float* normal;
  const uint8_t* mask;
  const int32_t* bond_type;
  Molecules lf;
  const uint8_t* geo;
  gorder::MapGrid map;
  int n_bonds, n_types, pbc;
  unsigned long long* out;
  cudaStream_t stream;
};

template <class Input, int kClasses, bool kMolNormal>
void launch_classes(const Input& input, const Launch& l) {
  if (gorder::table_fits(l.n_types, kClasses)) {
    p2_kernel<Input, true, kClasses, kMolNormal>
        <<<l.grid, kThreads, gorder::table_bytes(l.n_types, kClasses),
           l.stream>>>(input, l.box, l.normal, l.mask, l.bond_type, l.lf,
                       l.geo, l.map, l.n_bonds, l.n_types, l.pbc, l.out);
  } else {
    p2_kernel<Input, false, kClasses, kMolNormal>
        <<<l.grid, kThreads, 0, l.stream>>>(input, l.box, l.normal, l.mask,
                                            l.bond_type, l.lf, l.geo, l.map,
                                            l.n_bonds, l.n_types, l.pbc,
                                            l.out);
  }
}

template <class Input, int kClasses>
void launch_normals(const Input& input, const Launch& l, int mol_normals) {
  if (mol_normals) {
    launch_classes<Input, kClasses, true>(input, l);
  } else {
    launch_classes<Input, kClasses, false>(input, l);
  }
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
  const Launch l{dim3((n_bonds + kTile - 1) / kTile, n_frames),
                 static_cast<const float*>(box),
                 static_cast<const float*>(normal),
                 static_cast<const uint8_t*>(mask),
                 static_cast<const int32_t*>(bond_type),
                 Molecules{static_cast<const int32_t*>(classes),
                           static_cast<const int32_t*>(bond_mol), n_molecules},
                 static_cast<const uint8_t*>(geo), map, n_bonds, n_types,
                 pbc, static_cast<unsigned long long*>(out),
                 static_cast<cudaStream_t>(stream)};
  if (classes != nullptr) {
    launch_normals<Input, 3>(input, l, mol_normals);
  } else {
    launch_normals<Input, 1>(input, l, mol_normals);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream` and returns
// cudaGetLastError() (0 = launched). classes (B, M) int32 select the
// with_leaflets variant, out (B, 3, 2, T); null, out (B, 2, T).
// mol_normals = 1 selects the per_bond_normal variant: normal is then
// (B, M, 3) f32, else (3,). bond_mol (N,) int32 is given exactly when
// classes or per-molecule normals are; n_molecules is their M. The
// positions entry points of ordermap runs (pair int16, f32) take the map
// by value, its state (C, 2, T * n0 * n1 + 1) int64 with C the classes of
// out, added into; a null state, no map. geo (B, ceil(N/8)) uint8 is the
// geometry bitplane (the with_geom variant); null, every bond counts.

int p2_resid(const void* r, const void* base, const void* scale,
             const void* box, const void* normal, const void* mask,
             const void* bond_type, const void* classes,
             const void* bond_mol, const void* geo, void* out, int n_frames,
             int n_bonds, int n_types, int pbc, int mol_normals,
             int n_molecules, void* stream) {
  const ResidInput input{static_cast<const int16_t*>(r),
                         static_cast<const int32_t*>(base),
                         static_cast<const float*>(scale), 3 * n_bonds};
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
  const IntPositions input{static_cast<const int16_t*>(x),
                           static_cast<const int32_t*>(atom_a),
                           static_cast<const int32_t*>(atom_b),
                           static_cast<const float*>(scale), n_atoms};
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, gorder::MapGrid{}, n_frames, n_bonds, n_types, pbc,
                mol_normals, n_molecules, stream);
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
  const PairIntPositions input{static_cast<const int16_t*>(x),
                               static_cast<const int32_t*>(atom_a),
                               static_cast<const int32_t*>(atom_b),
                               static_cast<const float*>(scale), n_atoms};
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, map, n_frames, n_bonds, n_types, pbc, mol_normals,
                n_molecules, stream);
}

int p2_positions_f32(const void* x, const void* atom_a, const void* atom_b,
                     const void* box, const void* normal, const void* mask,
                     const void* bond_type, const void* classes,
                     const void* bond_mol, const void* geo, void* out,
                     gorder::MapGrid map, int n_frames, int n_atoms,
                     int n_bonds, int n_types, int pbc, int mol_normals,
                     int n_molecules, void* stream) {
  const FloatPositions input{static_cast<const float*>(x),
                             static_cast<const int32_t*>(atom_a),
                             static_cast<const int32_t*>(atom_b), n_atoms};
  return launch(input, box, normal, mask, bond_type, classes, bond_mol, geo,
                out, map, n_frames, n_bonds, n_types, pbc, mol_normals,
                n_molecules, stream);
}

// The message of a code that an entry point of this library returned.
const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// The spectral leaflet classifier's per-frame passes for Hopper (sm_90a):
// the similarity matrix, the subspace iteration of its top three
// eigenvectors, the two leading directions of the deflated span with
// their Laplacian products, and the energy-weighted embedding with its
// 100-step k-means.
//
// None replaces a Pallas kernel: gorder_tpu computes all of this with XLA
// ops under jax.lax.map, gorder_tpu/core/clustering.py `_spectral_labels`
// (:154-195; `_pairwise_sq_distances` :44-48, `_top3_subspace` :115-151,
// `_rayleigh_weighted` :198-235, `_kmeans2` :51-83) and
// `_spectral_labels_nystrom` (:251-322). The port's plain versions
// (gorder_tpu_torch/ops/spectral.py) are torch ops; on the card
// torch.linalg.qr and torch.linalg.svd run cuSOLVER one 256 x 3 matrix at a
// time, and the k-means takes some 20 launches a step.
//
// spectral_affinity: per frame b, heads p (n, 3) and box L, the weights
// w_ij = exp(-sigma * d2) of d2 = dx*dx + dy*dy + dz*dz (left to right) of
// the min-imaged d = p_i - p_j; the degree deg_i = sum_j w_ij in f64,
// rounded once, as the sum in order of the tiles of 32 heads J of c_iJ,
// the sum in index order of w_ij over the heads j of tile J; dis_i = 1 /
// sqrt(deg_i) where deg_i > 1e-10 (else 0); and S_ij = (w_ij * dis_i) *
// dis_j. Every f32 step is an _rn intrinsic and expf is compiled without
// fast math, so w is the plain version's. The minimum image is
// common.cuh's `min_image_fast` (no division but within a margin of a
// tie, where it divides), with the division for every pair of a frame
// whose heads leave [-L, 2L]. It is odd in d, so d2 and w are symmetric
// bit for bit: w_ij = w_ji. Two paths, which give the same bits:
//   - the triangle (frames of up to 288 heads, the main path's 256): one
//     block of 1,024 threads an SM takes frame after frame, and holds a
//     frame's upper triangle w_ij, j >= i, in shared memory as 32 x 32
//     tiles (w_ab, a <= b, in tile (a/32, b/32), row a%32, column
//     (a ^ b)%32, so that a warp reading a tile's row or column meets
//     every bank once; 167 KiB in all at 256 heads), each tile a warp's.
//     The warp writes its tiles' blocks of S, then computes the next
//     frame's weights into them, two a lane side by side (rows r and r +
//     16), each once, and their sums c_iJ; so one frame's stores drain
//     while the next one's weights are computed. Between the two, the
//     degrees add the sums and the next frame's heads are copied in;
//   - two passes (larger frames, up to the dense path's 20,000 heads): one
//     block of 256 threads a frame, heads through shared memory in tiles;
//     pass 1 gives each thread a column j and sums its weights in row order
//     a tile of 32 at a time, pass 2 computes them again and writes S row
//     after row.
//
// top3_subspace: per frame, the filtered matrix gp (n, n) f32 (S rescaled
// and squared 12 times by torch), the unfiltered S (n, n) f32 and a start
// basis (n, 3) f32 -> Q (n, 3) f32: Q of the start basis, `iters` steps
// Q <- QR(gp' Q), one step Q <- QR(S' Q), Q kept in f64 between the steps
// and rounded to f32 once. The matrices are symmetric but for the last
// ulp (S_ij = (w_ij d_i) d_j against (w_ij d_j) d_i), and the kernel reads
// them by columns: column t of the product, y_t = sum_i m[i][t] q_i, each
// f32 entry times the f64 q_i by a fused multiply-add in f64 in row
// order within a thread. Each QR is Householder's in f64 (after the
// filter a step's input has a condition number up to 7.8e7: Gram-Schmidt
// and Cholesky-QR in f32 lose its orthogonality, and Cholesky-QR2 in f64
// stands at the edge of its range, ~1e8), in three sums (one a reflector:
// |x|^2, x . y_c of the later columns c, and v_j . x of the earlier
// reflectors; v_k . y_c = x . y_c - alpha y_c[k] needs no sum of its
// own), and Q = [I; 0] - V T V_top' from V's compact WY form with no sum
// at all. (thin_qr3, which this kernel replaced with the products between
// its launches, took eight block sums a QR.) A reflection of a zero
// column is skipped (LAPACK's tau = 0). Persistent blocks of 256 threads
// take frame after frame, as many as the SMs hold: on the ring, whose 128
// KiB leave one an SM, 132 frames in flight, 33 MiB at 256 heads, within
// the card's 50 MB L2, which serves a frame's later passes (two an SM,
// 66 MiB, overflowed it). Three paths (`subspace_plan`):
//   - the ring (up to 1,024 rows: the dense path's 256 heads, Nystrom's
//     1,024 landmarks): the matrices stream through four 32 KiB tiles of
//     whole rows in shared memory, copied by cp.async three tiles ahead
//     across passes and frames, so that the copies run under the products
//     and the QRs. Up to 256 rows a lane takes four columns (one 16-byte
//     load a row) and every fourth row of a tile, the four row groups
//     meeting by shuffles, so that a row of Q, read from shared memory,
//     serves four columns; and one warp takes the QR, its rows in
//     registers and every sum a xor butterfly, between two barriers.
//     Larger frames: a thread's columns t + 256 k, the QR's sums over the
//     block;
//   - "shared" (up to 3,657 rows) and "device": the matrices read straight
//     from device memory, 8 rows of 4 columns ahead a thread, Q and y in
//     shared memory or in a scratch buffer.
// PERF.md §6 has the times of each design tried on the card.
//
// top2_span: per frame, the (n, 3) span, the degree and, on the dense path,
// S -> u2 (n, 2) and lap(u2) = u2 - S' u2 (n, 2): v0 = sqrt(max(deg, 0)) /
// max(|.|, 1e-30) and the span's part along it in one block sum, the
// deflated D = span - v0 (v0' span) and its 3 x 3 Gram D'D in a second,
// whose eigenpairs come from cyclic Jacobi in registers (every thread the
// same), and U_k = D V_k / max(sigma_k, 1e-30) for the two largest sigma_k
// = sqrt(lambda_k): the two leading left singular vectors, in f64, rounded
// to f32. The third direction (sigma ~ 0 after deflation) is never
// formed. Then S' u2 of the f32 u2 by columns, as top3_subspace's
// products, u2 from shared memory in f64: S is read once, where torch's
// product and subtraction read it and wrote lap apart. With S and up to
// 1,024 rows, persistent blocks stream S through top3_subspace's ring
// (its first tiles copied under the frame's sums); else one block a
// frame reads it straight from device memory.
//
// rayleigh_kmeans: per frame, u2 (n, 2) and its Laplacian products lap(u2)
// (n, 2) -> (n,) int32 labels. The 2 x 2 Rayleigh matrix h = u2' lap(u2)
// (h01 = a' lap(b)) in f64 and its eigenpairs ascending (one Jacobi
// rotation), the weight w = sqrt(max(l0, 1e-9) / max(l1, 1e-9)), the rows
// (u2 q0, w u2 q1) normalized where their norm > 1e-10, rounded to f32;
// then k-means, k = 2: c0 = row 0, c1 = the row farthest from it (the
// lowest row on ties, as torch.argmax), at most `iters` steps of labels d1
// < d0 (f32 squared distances, _rn) and centroids from f64 sums, a cluster
// left empty falling back to row 0, and the final labels d1 < d0. It stops
// at the fixed point: the sums run in a fixed order over the rows, so a
// step's centroids are a function of its labels alone; once the labels of
// step t >= 2 equal those of step t - 1, the centroids of step t equal
// those of step t - 1, and every later step repeats step t bit for bit, so
// its labels are the final ones `iters` steps would give. `steps` (if
// given) takes the centroid updates each frame ran: t - 1, or `iters`. Two
// paths:
//   - one warp a frame (up to kWarpRows * 32 = 256 rows): 8 rows a lane in
//     registers, every sum and the farthest-point argmax a xor butterfly of
//     shuffles (each level adds the same two operands in every lane, so
//     every lane holds the same total), no barrier; a lane keeps its rows'
//     labels as bits, and one __any_sync a step finds the fixed point;
//   - one block of 256 threads a frame (larger frames): the rows in shared
//     memory (8 bytes a row) or a scratch buffer, block sums of warp
//     butterflies and one barrier a step, the changed labels counted in
//     the same sum against the previous step's labels, kept in `labels`.
//
// What bounds them on this card, at the clustering benchmark's 256 heads:
// spectral_affinity and top2_span their bytes (S written once, read once:
// 256 KB a frame), top3_subspace its bytes too (gp and S once each at the
// least) and the f32 -> f64 conversion of each entry it multiplies (16 a
// clock an SM), rayleigh_kmeans its latency: it touches 16 bytes a row,
// and its time is a frame's chain of dependent reductions (3 + 5 a step).
// What the designs do about it: one launch a batch, a block (or warp) a
// frame, every reduction on chip, where cuSOLVER took several launches a
// matrix and torch's k-means some 2,000 a call. The similarity computes
// each weight once from the on-chip triangle, and overlaps a frame's
// stores with the next frame's weights in the same warps, for its block
// fills an SM (store warps beside weight warps, behind per-tile counters,
// fell behind). The subspace iteration keeps its frames' matrices within
// L2 across its passes and its copies under its products and QRs; the
// span forms its Laplacian products as it goes.
// The k-means takes warp shuffles only and stops when its labels stop
// changing.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / gorder::kWarpSize;
// The dynamic shared memory a block may take without opting in, less the
// static buffers of the reductions.
constexpr size_t kMaxDynamic = 40 * 1024;
// A block may take up to the card's 227 KiB of shared memory.
constexpr size_t kMaxShared = 227 * 1024;

// Sums of K doubles over the block. Every thread gets the totals: the warps'
// butterfly sums are equal in every lane, and every thread adds the warps'
// partials in the same order. The two halves of the buffer alternate, so
// one barrier a sum is enough: a warp cannot write a half again before
// every thread has passed the barrier of the sum between.
template <int K>
class BlockSum {
 public:
  __device__ explicit BlockSum(double* buffer) : buf_(buffer) {}

  __device__ void operator()(double (&v)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int off = gorder::kWarpSize / 2; off > 0; off >>= 1)
        v[k] = __dadd_rn(v[k], __shfl_xor_sync(gorder::kFullWarp, v[k], off));
    double* part = buf_ + parity_ * kWarps * K;
    if ((threadIdx.x & (gorder::kWarpSize - 1)) == 0) {
      const int warp = threadIdx.x / gorder::kWarpSize;
#pragma unroll
      for (int k = 0; k < K; ++k) part[warp * K + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, part[w * K + k]);
      v[k] = s;
    }
    parity_ ^= 1;
  }

 private:
  double* buf_;  // 2 * kWarps * K doubles of shared memory
  int parity_ = 0;
};

// The sum of v over the warp, the same in every lane.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = gorder::kWarpSize / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(gorder::kFullWarp, v, off));
  return v;
}

// ------------------------------------------------------- spectral_affinity

// The triangle path: a block of 1,024 threads an SM, frame after frame.
constexpr int kTriThreads = 1024;
constexpr int kTriWarps = kTriThreads / gorder::kWarpSize;
constexpr int kTile = 32;
// A diagonal tile's upper half takes 17 warp rows: row 0, the pairs of
// rows r and 32 - r (32 weights together) for r = 1 .. 15, and row 16.
constexpr int kDiagRows = 17;
// The rows of S's block a warp loads at a time, ahead of their stores.
constexpr int kStoreRows = 16;

struct AffinityArgs {
  const float* heads;  // (B, n, 3)
  const float* box;    // (B, 3)
  float* s;            // (B, n, n)
  float* degree;       // (B, n)
  int n_frames, n, tile;
  float sigma;
};

// Tiles of 32 heads of an n-head frame, and the shared memory of the
// triangle path: the upper triangle's T (T + 1) / 2 tiles of 32 x 32 f32;
// each head's T f64 partial degrees (one a tile of 32 heads), its
// 1/sqrt(degree), and its x, y, z in two frames (this one and the next);
// and two frames' flags of each warp's heads in [-L, 2L].
__host__ __device__ inline int tiles_of(int n) { return (n + kTile - 1) / kTile; }

inline size_t triangle_bytes(int n) {
  const size_t t = tiles_of(n);
  return t * (t + 1) / 2 * kTile * kTile * sizeof(float) +
         (t * sizeof(double) + 7 * sizeof(float)) * static_cast<size_t>(n) +
         2 * kTriWarps * sizeof(int);
}

// The offset of tile (A, B), A <= B, of a triangle of T tiles a side, in
// floats: the rows of tiles above A hold T, T - 1, ... tiles.
__device__ __forceinline__ int tile_offset(int A, int B, int T) {
  return (A * T - A * (A - 1) / 2 + (B - A)) * kTile * kTile;
}

// Where w_ab = w_ba (a <= b) lies within its tile: row a % 32, column
// (a ^ b) % 32. The column is symmetric in a and b, and for a fixed head
// the 32 heads of a tile take 32 different columns: a warp reading a row
// or a column meets every bank once.
__device__ __forceinline__ int in_tile(int lo5, int a5, int b5) {
  return lo5 * kTile + ((a5 ^ b5) & (kTile - 1));
}

// The min-imaged p - q without a division (common.cuh min_image_fast):
// `tie` is set where a component lies within the band of a tie, and the
// offset must be taken again with `exact_offset`.
template <bool kPbc>
__device__ __forceinline__ float3 fast_offset(float3 p, float3 q, float3 L,
                                              float3 inv, float edge,
                                              bool& tie) {
  return make_float3(
      gorder::min_image_fast<kPbc>(p.x, q.x, L.x, inv.x, edge, tie),
      gorder::min_image_fast<kPbc>(p.y, q.y, L.y, inv.y, edge, tie),
      gorder::min_image_fast<kPbc>(p.z, q.z, L.z, inv.z, edge, tie));
}

// The min-imaged p - q with min_image's division.
template <bool kPbc>
__device__ __forceinline__ float3 exact_offset(float3 p, float3 q, float3 L) {
  return make_float3(gorder::offset<kPbc>(p.x, q.x, L.x),
                     gorder::offset<kPbc>(p.y, q.y, L.y),
                     gorder::offset<kPbc>(p.z, q.z, L.z));
}

// exp(-sigma * d2), d2 summed x, y, z in order.
__device__ __forceinline__ float gaussian(float3 d, float sigma) {
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d.x, d.x), __fmul_rn(d.y, d.y)),
                             __fmul_rn(d.z, d.z));
  return expf(__fmul_rn(-sigma, d2));
}

// The weight of p and q: without a division where `fast` (the frame's
// heads in [-L, 2L]) and the pair is clear of a tie, else with min_image's.
template <bool kPbc>
__device__ __forceinline__ float weight(float3 p, float3 q, float3 L,
                                        float3 inv, float edge, bool fast,
                                        float sigma) {
  bool tie = !fast;
  float3 d = fast_offset<kPbc>(p, q, L, inv, edge, tie);
  if (__builtin_expect(tie, 0)) d = exact_offset<kPbc>(p, q, L);
  return gaussian(d, sigma);
}

// 1 / sqrt(deg) where deg > 1e-10, else 0 (the plain version's guard).
__device__ __forceinline__ float inv_sqrt_degree(float deg) {
  return deg > 1e-10f ? __fdiv_rn(1.0f, __fsqrt_rn(deg)) : 0.0f;
}

// The frame's box, 1/L and the band of min_image_fast: `fast` where every
// head lies in [-L, 2L] (always without PBC). Every thread of the block
// calls it (it synchronizes), after it has checked `in` over its heads.
struct Frame {
  float3 L, inv;
  float edge;
  bool fast;
};

template <bool kPbc>
__device__ __forceinline__ Frame frame_of(const float* box, int b, bool in) {
  Frame f;
  f.L = make_float3(box[3 * b], box[3 * b + 1], box[3 * b + 2]);
  f.inv = make_float3(__frcp_rn(f.L.x), __frcp_rn(f.L.y), __frcp_rn(f.L.z));
  f.edge = gorder::tie_edge(gorder::kMinMargin);
  f.fast = __syncthreads_and(in) || !kPbc;
  return f;
}

__device__ __forceinline__ bool head_in_range(float3 p, float3 L) {
  return gorder::in_range(p.x, L.x) & gorder::in_range(p.y, L.y) &
         gorder::in_range(p.z, L.z);
}

// The triangle path's shared memory, carved from the dynamic allocation.
struct Triangle {
  float* tri;               // T (T + 1) / 2 tiles
  double* chunk;            // (T, n): head i's degree over tile J
  float* dis;               // (n)
  float* heads;             // (2, n, 3): frames of even and odd rank
  int* fast;                // (2, kTriWarps)
  int n, T;

  __device__ explicit Triangle(float* smem, int n_heads)
      : n(n_heads), T(tiles_of(n_heads)) {
    tri = smem;
    chunk = reinterpret_cast<double*>(tri + T * (T + 1) / 2 * kTile * kTile);
    dis = reinterpret_cast<float*>(chunk + T * n);
    heads = dis + n;
    fast = reinterpret_cast<int*>(heads + 6 * n);
  }

  // the heads of the frame of rank k, x y z a head
  __device__ __forceinline__ float* frame(int k) const {
    return heads + (k % 2) * 3 * n;
  }
};

__device__ __forceinline__ float3 head_at(const float* h, int i) {
  return make_float3(h[3 * i], h[3 * i + 1], h[3 * i + 2]);
}

// Every thread starts asynchronous copies (cp.async) of frame b's heads
// into the heads' buffer of rank k; nothing waits for them until
// `flag_frame`.
__device__ __forceinline__ void copy_frame(const AffinityArgs& a,
                                           const Triangle& t, int b, int k) {
  const float* src = a.heads + static_cast<size_t>(b) * a.n * 3;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(t.frame(k)));
  for (int e = threadIdx.x; e < 3 * a.n; e += kTriThreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4 * e),
                 "l"(src + e)
                 : "memory");
}

// Every thread waits for its copies and, after a barrier, flags its warp's
// heads of frame b (rank k) in [-L, 2L] (the flags are read after the next
// barrier).
__device__ __forceinline__ void flag_frame(const AffinityArgs& a,
                                           const Triangle& t, int b, int k) {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int i = threadIdx.x;
  bool in = true;
  if (i < t.n)
    in = head_in_range(head_at(t.frame(k), i),
                       make_float3(a.box[3 * b], a.box[3 * b + 1],
                                   a.box[3 * b + 2]));
  in = __all_sync(gorder::kFullWarp, in);
  if (i % gorder::kWarpSize == 0)
    t.fast[(k % 2) * kTriWarps + i / gorder::kWarpSize] = in;
}

// Warp row rho of diagonal tile A: the pair (A*32 + r5, A*32 + c5) of the
// lane, inactive where the row takes no pair. Row 0 is the tile's row 0;
// rows rho >= 1 hold its row rho (columns >= rho) and its row 32 - rho
// (the other columns), none of the latter for rho = 16.
__device__ __forceinline__ bool diagonal_row(int rho, int lane, int& r5,
                                             int& c5) {
  r5 = rho;
  c5 = lane;
  if (lane >= rho) return true;
  r5 = kTile - rho;
  c5 = kTile - rho + lane;
  return rho < kDiagRows - 1;
}

// What the weights of a frame need: its heads (rank k) and box, whether
// they all lie in [-L, 2L], 1/L and the band of min_image_fast.
struct Weighing {
  const float* h;
  float3 L, inv;
  float edge, sigma;
  bool fast;
};

template <bool kPbc>
__device__ __forceinline__ Weighing weighing(const AffinityArgs& a,
                                             const Triangle& t, int b,
                                             int k) {
  Weighing g;
  g.h = t.frame(k);
  g.L = make_float3(a.box[3 * b], a.box[3 * b + 1], a.box[3 * b + 2]);
  g.inv = make_float3(__frcp_rn(g.L.x), __frcp_rn(g.L.y), __frcp_rn(g.L.z));
  g.edge = gorder::tie_edge(gorder::kMinMargin);
  g.sigma = a.sigma;
  g.fast = true;
  for (int w = 0; w < kTriWarps; ++w)
    g.fast &= t.fast[(k % 2) * kTriWarps + w] != 0;
  g.fast |= !kPbc;
  return g;
}

constexpr int kHalf = kTile / 2;

// Rows u and u + 16 of tile (A, B) off the diagonal: two weights a lane,
// side by side, with its column head q; a lane past the last head (not
// `live`) stores 0, so that the degrees add whole tiles. The rows of tile
// A < T - 1 are all heads.
template <bool kPbc>
__device__ __forceinline__ void weigh_rows(const Weighing& g, float* tile,
                                           int A, int u, float3 q, bool live) {
  const int lane = threadIdx.x % gorder::kWarpSize;
  const float3 p0 = head_at(g.h, A * kTile + u);
  const float3 p1 = head_at(g.h, A * kTile + u + kHalf);
  bool tie0 = !g.fast, tie1 = !g.fast;
  float3 d0 = fast_offset<kPbc>(p0, q, g.L, g.inv, g.edge, tie0);
  float3 d1 = fast_offset<kPbc>(p1, q, g.L, g.inv, g.edge, tie1);
  if (__builtin_expect(tie0 | tie1, 0)) {
    if (tie0) d0 = exact_offset<kPbc>(p0, q, g.L);
    if (tie1) d1 = exact_offset<kPbc>(p1, q, g.L);
  }
  tile[in_tile(u, u, lane)] = live ? gaussian(d0, g.sigma) : 0.0f;
  tile[in_tile(u + kHalf, u + kHalf, lane)] =
      live ? gaussian(d1, g.sigma) : 0.0f;
}

// The upper half of diagonal tile D, in its 17 warp rows.
template <bool kPbc>
__device__ __forceinline__ void weigh_diagonal(const Weighing& g,
                                               float* tile, int D, int n) {
  const int lane = threadIdx.x % gorder::kWarpSize;
  for (int rho = 0; rho < kDiagRows; ++rho) {
    int r5, c5;
    if (!diagonal_row(rho, lane, r5, c5)) continue;
    const int ia = D * kTile + r5, ib = D * kTile + c5;
    const float w = weight<kPbc>(head_at(g.h, min(ia, n - 1)),
                                 head_at(g.h, min(ib, n - 1)), g.L, g.inv,
                                 g.edge, g.fast, g.sigma);
    tile[in_tile(r5, r5, c5)] = ib < n ? w : 0.0f;
  }
}

// The degrees of frame b from its chunks (each head's tiles in order) and
// 1/sqrt(degree).
__device__ __forceinline__ void degrees(const AffinityArgs& a,
                                        const Triangle& t, int b) {
  const int n = t.n;
  for (int i = threadIdx.x; i < n; i += kTriThreads) {
    double acc = t.chunk[i];
    for (int J = 1; J < t.T; ++J) acc += t.chunk[J * n + i];
    const float deg = static_cast<float>(acc);
    a.degree[static_cast<size_t>(b) * n + i] = deg;
    t.dis[i] = inv_sqrt_degree(deg);
  }
}

// A tile's part of the degrees, f64 in index order: w_ab of each lane's
// row a % 32 = r5 over the tile's columns (`row_sum`), of its column
// b % 32 = c5 over the tile's rows (`column_sum`), or of its head over a
// diagonal tile (`diagonal_sum`). Lanes past the last head add +0.
__device__ __forceinline__ double row_sum(const float* tile, int r5) {
  float v[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) v[c] = tile[r5 * kTile + (r5 ^ c)];
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc += v[c];
  return acc;
}

__device__ __forceinline__ double column_sum(const float* tile, int c5) {
  float v[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) v[r] = tile[r * kTile + (r ^ c5)];
  double acc = 0.0;
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc += v[r];
  return acc;
}

__device__ __forceinline__ double diagonal_sum(const float* tile, int i5) {
  float v[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) v[c] = tile[min(i5, c) * kTile + (i5 ^ c)];
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc += v[c];
  return acc;
}

// Rows r0 .. r0 + m - 1 of S's block (R, C) from tile (A, B): w of
// (R*32 + r5, j) is tile row r5 (S's rows in A), or the lane's tile row
// (S's rows in B), the lower of the two on the diagonal; each store of the
// warp 32 consecutive floats. Rows past the frame's last read what lies
// there, and store none.
template <int kRows>
__device__ __forceinline__ void store_rows(const Triangle& t, float* s,
                                           const float* tile, int A, int B,
                                           bool rows, int r0, int m) {
  const int n = t.n;
  const int lane = threadIdx.x % gorder::kWarpSize;
  const int R = rows ? A : B, C = rows ? B : A;
  const int j = C * kTile + lane;
  const float dis_j = t.dis[min(j, n - 1)];
  float w[kRows], dis_i[kRows];
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int r5 = r0 + e;
    const int lo5 = A == B ? min(r5, lane) : (rows ? r5 : lane);
    w[e] = tile[in_tile(lo5, r5, lane)];
    dis_i[e] = t.dis[R * kTile + r5];
  }
  float* out = s + static_cast<size_t>(R * kTile + r0) * n + j;
#pragma unroll
  for (int e = 0; e < kRows; ++e)
    if (j < n && r0 + e < m)
      out[static_cast<size_t>(e) * n] =
          __fmul_rn(__fmul_rn(w[e], dis_i[e]), dis_j);
}

// The tiles of a warp, the same in every lane: item w, then 63 - w, 64 +
// w, ... of the tiles off the diagonal (row-major) and after them the
// diagonal ones, which weigh half as much. With 256 heads (28 + 8 tiles)
// each of the 32 warps takes one tile off the diagonal or two on it.
__device__ __forceinline__ int warp_item(int round, int warp) {
  return round * kTriWarps + (round % 2 ? kTriWarps - 1 - warp : warp);
}

__device__ __forceinline__ void item_tile(int item, int T, int& A, int& B) {
  const int off = T * (T - 1) / 2;
  if (item >= off) {
    A = B = item - off;
    return;
  }
  A = 0;
  while (item >= T - 1 - A) item -= T - 1 - A++;
  B = A + 1 + item;
}

// Each warp's tiles: S of frame b from them (unless b < 0), then the
// weights of frame `next` into them (unless next < 0, its heads of rank
// k). Off the diagonal the warp writes S's block (B, A), which reads the
// whole tile, then for each unit of rows u, u + 16 S's rows u and u + 16
// of block (A, B), which read those tile rows, and the new weights of
// those rows, then the tile's sums for the next frame's degrees; the warp
// alone reads and writes its tiles, in order, so that one frame's stores
// drain while the next one's weights are computed. A diagonal tile gives
// its block of S, then its new weights and their sums. Where a lane
// overwrites what another lane read, a __syncwarp lies between: block
// (B, A)'s lane u reads all of tile row u, and on the diagonal lanes read
// and write the tile in different orders; in the rows' loop each lane
// reads and writes only its own column.
template <bool kPbc>
__device__ void store_and_weigh(const AffinityArgs& a, const Triangle& t,
                                int b, int next, int k) {
  const int n = t.n, T = t.T;
  const int lane = threadIdx.x % gorder::kWarpSize;
  const int warp = threadIdx.x / gorder::kWarpSize;
  float* s = b < 0 ? nullptr : a.s + static_cast<size_t>(b) * n * n;
  Weighing g{};
  if (next >= 0) g = weighing<kPbc>(a, t, next, k);
  const int items = T * (T + 1) / 2;
  for (int round = 0; round * kTriWarps < items; ++round) {
    const int item = warp_item(round, warp);
    if (item >= items) continue;
    int A, B;
    item_tile(item, T, A, B);
    float* tile = t.tri + tile_offset(A, B, T);
    const int m = min(kTile, n - A * kTile);
    if (A == B) {
      if (s != nullptr)
        for (int r0 = 0; r0 < m; r0 += kStoreRows)
          store_rows<kStoreRows>(t, s, tile, A, A, true, r0, m);
      if (next >= 0) {
        __syncwarp();  // lane rho read (rho, rho ^ L), which lane L writes
        weigh_diagonal<kPbc>(g, tile, A, n);
        __syncwarp();
        if (A * kTile + lane < n)
          t.chunk[A * n + A * kTile + lane] = diagonal_sum(tile, lane);
      }
      continue;
    }
    if (s != nullptr)
      for (int r0 = 0; r0 < min(kTile, n - B * kTile); r0 += kStoreRows)
        store_rows<kStoreRows>(t, s, tile, A, B, false, r0,
                               min(kTile, n - B * kTile));
    __syncwarp();  // lane u read tile row u, which every lane rewrites
    const bool live = B * kTile + lane < n;
    const float3 q = next >= 0 ? head_at(g.h, min(B * kTile + lane, n - 1))
                               : make_float3(0.0f, 0.0f, 0.0f);
    for (int u = 0; u < kHalf; ++u) {
      if (s != nullptr) {
        store_rows<1>(t, s, tile, A, B, true, u, m);
        store_rows<1>(t, s, tile, A, B, true, u + kHalf, m);
      }
      if (next >= 0) weigh_rows<kPbc>(g, tile, A, u, q, live);
    }
    if (next >= 0) {
      __syncwarp();
      t.chunk[B * n + A * kTile + lane] = row_sum(tile, lane);
      if (live) t.chunk[A * n + B * kTile + lane] = column_sum(tile, lane);
    }
  }
}

// One block an SM takes frames blockIdx.x, + gridDim.x, ...: the weights
// of the first; then for each frame its degrees, with the next frame's
// heads copied meanwhile, and its S with the next frame's weights (every
// warp in each phase).
template <bool kPbc>
__global__ void __launch_bounds__(kTriThreads, 1)
    affinity_triangle_kernel(AffinityArgs a) {
  extern __shared__ float smem[];
  const Triangle t(smem, a.n);
  copy_frame(a, t, blockIdx.x, 0);
  flag_frame(a, t, blockIdx.x, 0);
  __syncthreads();
  store_and_weigh<kPbc>(a, t, -1, blockIdx.x, 0);
  __syncthreads();
  int k = 0;
  for (int b = blockIdx.x; b < a.n_frames; b += gridDim.x, ++k) {
    const int next = b + gridDim.x < a.n_frames ? b + gridDim.x : -1;
    if (next >= 0) copy_frame(a, t, next, k + 1);
    degrees(a, t, b);
    if (next >= 0) flag_frame(a, t, next, k + 1);
    __syncthreads();
    store_and_weigh<kPbc>(a, t, b, next, k + 1);
    __syncthreads();  // the next frame's tiles complete
  }
}

// Heads [start, start + m) of the frame into the shared x, y, z rows of
// `tile` floats each, and with `deg` their 1 / sqrt(degree) into the fourth.
__device__ __forceinline__ void load_heads(float* sm, const float* p,
                                           const float* deg, int start,
                                           int m, int tile) {
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const float* h = p + 3 * static_cast<size_t>(start + k);
    sm[k] = h[0];
    sm[tile + k] = h[1];
    sm[2 * tile + k] = h[2];
    if (deg != nullptr) sm[3 * tile + k] = inv_sqrt_degree(deg[start + k]);
  }
}

template <bool kPbc>
__global__ void __launch_bounds__(kThreads)
    affinity_kernel(AffinityArgs a) {
  extern __shared__ float aff_tile[];  // x, y, z, dis rows of a.tile
  const int b = blockIdx.x;
  const int n = a.n;
  const float* p = a.heads + static_cast<size_t>(b) * n * 3;
  float* deg = a.degree + static_cast<size_t>(b) * n;
  float* s = a.s + static_cast<size_t>(b) * n * n;
  const float* tx = aff_tile;
  const float* ty = aff_tile + a.tile;
  const float* tz = aff_tile + 2 * a.tile;
  const float* td = aff_tile + 3 * a.tile;
  const float3 box = make_float3(a.box[3 * b], a.box[3 * b + 1],
                                 a.box[3 * b + 2]);
  bool in = true;
  for (int k = threadIdx.x; k < n; k += kThreads)
    in &= head_in_range(make_float3(p[3 * k], p[3 * k + 1], p[3 * k + 2]),
                        box);
  const Frame f = frame_of<kPbc>(a.box, b, in);

  // pass 1: each thread a column j, its weights summed in f64 in row order
  // a tile of 32 rows at a time, the tiles' sums added in order (as the
  // triangle sums them)
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool active = j < n;
    const float3 q = active ? make_float3(p[3 * j], p[3 * j + 1], p[3 * j + 2])
                            : make_float3(0.0f, 0.0f, 0.0f);
    double acc = 0.0, chunk = 0.0;
    for (int start = 0; start < n; start += a.tile) {
      const int m = min(a.tile, n - start);
      __syncthreads();
      load_heads(aff_tile, p, nullptr, start, m, a.tile);
      __syncthreads();
      if (!active) continue;
      for (int c = 0; c < m; ++c) {
        chunk += weight<kPbc>(make_float3(tx[c], ty[c], tz[c]), q, f.L,
                              f.inv, f.edge, f.fast, a.sigma);
        const int row = start + c;  // the same in every thread
        if (row % kTile == kTile - 1 || row == n - 1) {
          acc += chunk;
          chunk = 0.0;
        }
      }
    }
    if (active) deg[j] = static_cast<float>(acc);
  }
  // the frame's degrees, written above by this block, are now visible to it
  __syncthreads();

  // pass 2: S row after row, each thread its column j
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool active = j < n;
    const float3 q = active ? make_float3(p[3 * j], p[3 * j + 1], p[3 * j + 2])
                            : make_float3(0.0f, 0.0f, 0.0f);
    const float dis_j = active ? inv_sqrt_degree(deg[j]) : 0.0f;
    for (int start = 0; start < n; start += a.tile) {
      const int m = min(a.tile, n - start);
      __syncthreads();
      load_heads(aff_tile, p, deg, start, m, a.tile);
      __syncthreads();
      if (!active) continue;
      float* row = s + static_cast<size_t>(start) * n + j;
      for (int c = 0; c < m; ++c) {
        const float w = weight<kPbc>(make_float3(tx[c], ty[c], tz[c]), q, f.L,
                                     f.inv, f.edge, f.fast, a.sigma);
        row[static_cast<size_t>(c) * n] =
            __fmul_rn(__fmul_rn(w, td[c]), dis_j);
      }
    }
  }
}

// ----------------------------------------------------------- top3_subspace

// Doubles a row of Q takes in shared memory (3 used): two 16-byte loads.
constexpr int kQStride = 4;
// The columns a thread takes in one sweep over a matrix's rows, past
// kThreads rows: the ring takes frames of up to kColsAtOnce * kThreads.
constexpr int kColsAtOnce = 4;

struct SubspaceArgs {
  const float* gp;     // (B, n, n): the filtered matrix
  const float* s;      // (B, n, n): the unfiltered one
  const float* start;  // (B, n, 3)
  float* q;            // (B, n, 3)
  double* scratch;     // (B, 8n) when the working rows do not fit on chip
  int n_frames, n, iters;
  int aligned;         // both matrices 16-byte aligned and n % 4 == 0
};

// Rows of the matrix a thread loads ahead of their products, kColsAtOnce
// columns a row: 32 loads in flight a thread.
constexpr int kAhead = 32 / kColsAtOnce;

// y = m^T q on the thread's columns t (kColsAtOnce at a time, t, t +
// kThreads, ...): y[c][t] = sum_i m[i][t] q[i][c], the f32 entries times
// the f64 Q by fused multiply-adds in f64, in row order. A warp reads a
// row's neighbouring columns: 128 bytes a load.
__device__ __forceinline__ void transposed_product(const float* m,
                                                   const double* qs,
                                                   double* y, int n) {
  constexpr int kCols = kColsAtOnce;
  constexpr int kRows = kAhead;
  for (int t0 = threadIdx.x; t0 < n; t0 += kCols * kThreads) {
    double acc[kCols][3];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      acc[k][0] = acc[k][1] = acc[k][2] = 0.0;
    for (int i0 = 0; i0 < n; i0 += kRows) {
      float g[kRows][kCols];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int i = i0 + u, t = t0 + k * kThreads;
          g[u][k] = i < n && t < n
                        ? __ldg(m + static_cast<size_t>(i) * n + t)
                        : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (i0 + u >= n) break;  // the same in every thread
        const double* qi = qs + (i0 + u) * kQStride;
        const double2 q01 = *reinterpret_cast<const double2*>(qi);
        const double q2 = qi[2];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const double x = static_cast<double>(g[u][k]);
          acc[k][0] = fma(x, q01.x, acc[k][0]);
          acc[k][1] = fma(x, q01.y, acc[k][1]);
          acc[k][2] = fma(x, q2, acc[k][2]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int t = t0 + k * kThreads;
      if (t < n) {
        y[t] = acc[k][0];
        y[n + t] = acc[k][1];
        y[2 * n + t] = acc[k][2];
      }
    }
  }
}

// Q of the Householder QR of y (n x 3, column-major, f64), into qs (rows of
// kQStride), each thread its rows i = threadIdx.x (mod kThreads), in three
// block sums. Reflector k of x = y[k:, k] (after reflectors 0 .. k-1): v_k
// = x - alpha e_k, alpha = -sign(x_0) |x|, tau_k = 2 / v'v with v'v =
// 2 |x| (|x| + |x_0|), 0 for a zero column. Sum k gives |x|^2, x . y_c
// for the later columns c (so v_k . y_c = x . y_c - alpha y_c[k] needs no
// sum of its own) and v_j . x for the earlier reflectors j (so v_j . v_k =
// v_j . x - alpha v_j[k]). The later columns' rows below k take the
// reflection; row k's entries (R's) are never read again, so they are left
// as they are and no thread writes a value that another reads in the same
// step. Then Q = H0 H1 H2 [I; 0] = [I; 0] - V T V_top' (V's compact WY form:
// T upper triangular from the taus and the v_j . v_k), with no sum.
__device__ __forceinline__ void householder_q(double* y, double* qs, int n,
                                              BlockSum<3>& sum) {
  double tau[3], head[3], w01 = 0.0, w02 = 0.0, w12 = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double t[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i < k) continue;
      const double x = y[k * n + i];
      t[0] = fma(x, x, t[0]);
      if (k == 0) {
        t[1] = fma(x, y[n + i], t[1]);
        t[2] = fma(x, y[2 * n + i], t[2]);
      } else if (k == 1) {
        t[1] = fma(x, y[2 * n + i], t[1]);
        t[2] = fma(y[i], x, t[2]);  // v_0 . x, rows >= 1
      } else {
        t[1] = fma(y[i], x, t[1]);      // v_0 . x, rows >= 2
        t[2] = fma(y[n + i], x, t[2]);  // v_1 . x
      }
    }
    sum(t);
    const double norm = sqrt(t[0]);
    const double x0 = y[k * n + k];
    const double alpha = x0 >= 0.0 ? -norm : norm;
    const double vv = 2.0 * norm * (norm + fabs(x0));
    head[k] = x0 - alpha;
    tau[k] = vv > 0.0 ? 2.0 / vv : 0.0;
    if (k == 1) w01 = t[2] - alpha * y[1];
    if (k == 2) {
      w02 = t[1] - alpha * y[2];
      w12 = t[2] - alpha * y[n + 2];
    }
    if (k == 2 || tau[k] == 0.0) continue;  // the same in every thread
    // tau_k (v_k . y_c) for the later columns c
    const double f1 = k == 0 ? tau[k] * (t[1] - alpha * y[n]) : 0.0;
    const double f2 =
        tau[k] * ((k == 0 ? t[2] : t[1]) - alpha * y[2 * n + k]);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i <= k) continue;
      const double v = y[k * n + i];
      if (k == 0) y[n + i] = fma(-f1, v, y[n + i]);
      y[2 * n + i] = fma(-f2, v, y[2 * n + i]);
    }
  }
  // T and M = T V_top' (V_top: V's first three rows, V[r][m] = 0 above the
  // diagonal, head_m on it, y[m][r] below)
  const double t01 = -tau[0] * tau[1] * w01;
  const double t12 = -tau[1] * tau[2] * w12;
  const double t02 = -tau[2] * (tau[0] * w02 + t01 * w12);
  const double v10 = y[1], v20 = y[2], v21 = y[n + 2];
  const double vt[3][3] = {{head[0], 0.0, 0.0},
                           {v10, head[1], 0.0},
                           {v20, v21, head[2]}};
  double m[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[0][c] = tau[0] * vt[c][0] + t01 * vt[c][1] + t02 * vt[c][2];
    m[1][c] = tau[1] * vt[c][1] + t12 * vt[c][2];
    m[2][c] = tau[2] * vt[c][2];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v[j] = i < j ? 0.0 : i == j ? head[j] : y[j * n + i];
    double* qi = qs + i * kQStride;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      qi[c] = (i == c ? 1.0 : 0.0) -
              (v[0] * m[0][c] + v[1] * m[1][c] + v[2] * m[2][c]);
  }
}

// householder_q for frames of up to kThreads rows by warp 0 alone: its
// rows (i = lane + 32 r) in registers, every sum a xor butterfly (the same
// in every lane), no barrier; row k's entries, which every lane needs,
// come from lane k by shuffles. The same reflectors, sums and WY form.
__device__ __forceinline__ void householder_q_warp(const double* y,
                                                   double* qs, int n) {
  constexpr int kR = kThreads / gorder::kWarpSize;
  const int lane = threadIdx.x % gorder::kWarpSize;
  double a[kR][3];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = lane + gorder::kWarpSize * r;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[r][c] = i < n ? y[c * n + i] : 0.0;
  }
  double tau[3], head[3], w01 = 0.0, w02 = 0.0, w12 = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double t[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r == 0 && lane < k) continue;  // rows above k
      const double x = a[r][k];
      t[0] = fma(x, x, t[0]);
      if (k == 0) {
        t[1] = fma(x, a[r][1], t[1]);
        t[2] = fma(x, a[r][2], t[2]);
      } else if (k == 1) {
        t[1] = fma(x, a[r][2], t[1]);
        t[2] = fma(a[r][0], x, t[2]);
      } else {
        t[1] = fma(a[r][0], x, t[1]);
        t[2] = fma(a[r][1], x, t[2]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = warp_sum(t[c]);
    double row[3];  // row k
#pragma unroll
    for (int c = 0; c < 3; ++c)
      row[c] = __shfl_sync(gorder::kFullWarp, a[0][c], k);
    const double norm = sqrt(t[0]);
    const double x0 = row[k];
    const double alpha = x0 >= 0.0 ? -norm : norm;
    const double vv = 2.0 * norm * (norm + fabs(x0));
    head[k] = x0 - alpha;
    tau[k] = vv > 0.0 ? 2.0 / vv : 0.0;
    if (k == 1) w01 = t[2] - alpha * row[0];
    if (k == 2) {
      w02 = t[1] - alpha * row[0];
      w12 = t[2] - alpha * row[1];
    }
    if (k == 2 || tau[k] == 0.0) continue;  // the same in every lane
    const double f1 = k == 0 ? tau[k] * (t[1] - alpha * row[1]) : 0.0;
    const double f2 = tau[k] * ((k == 0 ? t[2] : t[1]) - alpha * row[2]);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r == 0 && lane <= k) continue;  // rows k and above
      const double v = a[r][k];
      if (k == 0) a[r][1] = fma(-f1, v, a[r][1]);
      a[r][2] = fma(-f2, v, a[r][2]);
    }
  }
  const double t01 = -tau[0] * tau[1] * w01;
  const double t12 = -tau[1] * tau[2] * w12;
  const double t02 = -tau[2] * (tau[0] * w02 + t01 * w12);
  const double v10 = __shfl_sync(gorder::kFullWarp, a[0][0], 1);
  const double v20 = __shfl_sync(gorder::kFullWarp, a[0][0], 2);
  const double v21 = __shfl_sync(gorder::kFullWarp, a[0][1], 2);
  const double vt[3][3] = {{head[0], 0.0, 0.0},
                           {v10, head[1], 0.0},
                           {v20, v21, head[2]}};
  double m[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[0][c] = tau[0] * vt[c][0] + t01 * vt[c][1] + t02 * vt[c][2];
    m[1][c] = tau[1] * vt[c][1] + t12 * vt[c][2];
    m[2][c] = tau[2] * vt[c][2];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = lane + gorder::kWarpSize * r;
    if (i >= n) continue;
    double v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v[j] = i < j ? 0.0 : i == j ? head[j] : a[r][j];
    double* qi = qs + i * kQStride;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      qi[c] = (i == c ? 1.0 : 0.0) -
              (v[0] * m[0][c] + v[1] * m[1][c] + v[2] * m[2][c]);
  }
}

// The ring: a persistent block streams its frames' matrices through
// kRingStages tiles of whole rows in shared memory, filled by cp.async
// kRingStages - 1 tiles ahead of the products, across passes and frames:
// the copies of a frame's next pass run under its QR, and no register
// waits on a load.
constexpr int kRingStages = 4;
constexpr int kStageFloats = 8192;  // 32 KiB a stage
constexpr size_t kRingBytes = kRingStages * kStageFloats * sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// The tiles a persistent block streams: for each of its frames (b =
// blockIdx.x, then + gridDim.x), iters + 1 passes over the frame's n x n
// matrix, gp for the first iters and s for the last, each in `tiles`
// tiles of `rows` whole rows (the last one ragged), a row `ldn` floats
// apart in the stage (n rounded up to a multiple of 4, so that a row
// starts on 16 bytes).
struct TileStream {
  const float* gp;
  const float* s;
  int n, ldn, n_frames, iters, rows, tiles;
  bool aligned;
  // the next tile to copy (frame b, pass, tile k; none once b >= n_frames)
  // and the tiles issued so far
  int b, pass, k, issued;

  __device__ TileStream(const float* gp_, const float* s_, int n_,
                        int n_frames_, int iters_, bool aligned_)
      : gp(gp_),
        s(s_),
        n(n_),
        ldn((n_ + 3) & ~3),
        n_frames(n_frames_),
        iters(iters_),
        rows(kStageFloats / ((n_ + 3) & ~3)),
        tiles((n_ + rows - 1) / rows),
        aligned(aligned_),
        b(blockIdx.x),
        pass(0),
        k(0),
        issued(0) {}

  // Copies the next tile into its stage (16 bytes a copy where aligned,
  // else 4) and commits this thread's group, an empty one past the end, so
  // that every thread counts one group a tile.
  __device__ __forceinline__ void issue(float* ring) {
    if (b < n_frames) {
      const int row0 = k * rows;
      const float* src =
          (pass < iters ? gp : s) + (static_cast<size_t>(b) * n + row0) * n;
      const int count = min(rows, n - row0) * n;
      float* dst = ring + (issued % kRingStages) * kStageFloats;
      if (aligned)  // ldn == n
        for (int c = 4 * threadIdx.x; c < count; c += 4 * kThreads)
          cp_async16(dst + c, src + c);
      else
        for (int c = threadIdx.x; c < count; c += kThreads) {
          const int r = c / n;
          cp_async4(dst + r * ldn + (c - r * n), src + c);
        }
      if (++k == tiles) {
        k = 0;
        if (++pass > iters) {
          pass = 0;
          b += gridDim.x;
        }
      }
    }
    ++issued;
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Tile j, once every thread's copies of it have landed; its stage's
  // predecessor, which every thread has read by then, takes the copies
  // of tile j + kRingStages - 1.
  __device__ __forceinline__ const float* acquire(int j, float* ring) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingStages - 2));
    __syncthreads();
    issue(ring);
    return ring + (j % kRingStages) * kStageFloats;
  }
};

// y = m^T v of one pass through the ring (tiles j, j + 1, ...; j advances
// past them), v (n x kVec, f64) in shared memory, row i at v + kStride i:
// thread t takes columns t + k kThreads, each tile's rows in order, an f32
// entry times the f64 v_i by a fused multiply-add in f64. → acc[k][c] of
// column t + k kThreads.
template <int kCols, int kVec, int kStride>
__device__ __forceinline__ void ring_product(TileStream& ts, int& j,
                                             float* ring, const double* v,
                                             double (&acc)[kCols][kVec]) {
  const int n = ts.n;
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[k][c] = 0.0;
  for (int k = 0; k < ts.tiles; ++k, ++j) {
    const float* tile = ts.acquire(j, ring);
    const int row0 = k * ts.rows;
    const int rows = min(ts.rows, n - row0);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const double* vi = v + (row0 + r) * kStride;
      double w[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[c] = vi[c];
#pragma unroll
      for (int k2 = 0; k2 < kCols; ++k2) {
        const int t = threadIdx.x + k2 * kThreads;
        const double x =
            t < n ? static_cast<double>(tile[r * ts.ldn + t]) : 0.0;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[k2][c] = fma(x, w[c], acc[k2][c]);
      }
    }
  }
}

// ring_product for frames of up to kThreads rows, four columns a thread:
// lane l of warp w takes columns c0 = 32 w + 4 (l % 8) .. c0 + 3 (one
// 16-byte load a row) and the rows r = l / 8 (mod 4) of each tile, so a
// row of v serves four columns and eight lanes; the four row groups' sums
// meet by two xor shuffles. store(c, totals) is called for each column c
// < n by the lanes of row group 0.
template <int kVec, int kStride, class Store>
__device__ __forceinline__ void ring_product_wide(TileStream& ts, int& j,
                                                  float* ring,
                                                  const double* v,
                                                  Store store) {
  const int n = ts.n;
  const int lane = threadIdx.x % gorder::kWarpSize;
  const int c0 = 32 * (threadIdx.x / gorder::kWarpSize) + 4 * (lane % 8);
  const int group = lane / 8;
  double acc[4][kVec];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[k][c] = 0.0;
  for (int k = 0; k < ts.tiles; ++k, ++j) {
    const float* tile = ts.acquire(j, ring);
    const int row0 = k * ts.rows;
    const int rows = min(ts.rows, n - row0);
    if (c0 >= n) continue;  // the tile's barrier is behind this thread
#pragma unroll 2
    for (int r = group; r < rows; r += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(tile + r * ts.ldn + c0);
      const double* vi = v + (row0 + r) * kStride;
      double w[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[c] = vi[c];
      const double xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[e][c] = fma(xs[e], w[c], acc[e][c]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[e][c] = __dadd_rn(acc[e][c],
                            __shfl_xor_sync(gorder::kFullWarp, acc[e][c], 8));
      acc[e][c] = __dadd_rn(acc[e][c],
                            __shfl_xor_sync(gorder::kFullWarp, acc[e][c], 16));
    }
  if (group == 0)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < n) store(c0 + e, acc[e]);
}

// top3_subspace for frames of up to kColsAtOnce * kThreads rows: as
// top3_subspace_kernel, the matrices through the ring.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    top3_subspace_ring_kernel(SubspaceArgs a) {
  // the ring, then Q (kQStride n) and y (3n)
  extern __shared__ __align__(16) float ring[];
  __shared__ double red[2 * kWarps * 3];
  BlockSum<3> sum(red);
  const int n = a.n;
  double* qs = reinterpret_cast<double*>(ring + kRingStages * kStageFloats);
  double* y = qs + kQStride * n;
  TileStream ts(a.gp, a.s, n, a.n_frames, a.iters, a.aligned != 0);
  for (int j = 0; j < kRingStages - 1; ++j) ts.issue(ring);
  // up to kThreads rows: one warp's QR between two barriers
  const auto qr = [&] {
    if constexpr (kCols == 1) {
      __syncthreads();  // y whole
      if (threadIdx.x < gorder::kWarpSize) householder_q_warp(y, qs, n);
    } else {
      householder_q(y, qs, n, sum);
    }
  };
  int j = 0;
  for (int b = blockIdx.x; b < a.n_frames; b += gridDim.x) {
    __syncthreads();  // the last frame's readers of y and Q are done
    const float* st = a.start + static_cast<size_t>(b) * n * 3;
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) y[c * n + i] = st[3 * i + c];
    qr();
    for (int step = 0; step <= a.iters; ++step) {
      __syncthreads();  // Q whole, y free
      if constexpr (kCols == 1) {
        ring_product_wide<3, kQStride>(
            ts, j, ring, qs, [&](int t, const double(&tot)[3]) {
              y[t] = tot[0];
              y[n + t] = tot[1];
              y[2 * n + t] = tot[2];
            });
      } else {
        double acc[kCols][3];
        ring_product<kCols, 3, kQStride>(ts, j, ring, qs, acc);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int t = threadIdx.x + c * kThreads;
          if (t < n)
#pragma unroll
            for (int k = 0; k < 3; ++k) y[k * n + t] = acc[c][k];
        }
      }
      qr();
    }
    __syncthreads();  // Q whole
    float* out = a.q + static_cast<size_t>(b) * n * 3;
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[3 * i + c] = static_cast<float>(qs[i * kQStride + c]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A persistent block takes frame after frame: the start basis's QR, then
// `iters` steps q <- QR(gp' q) and one q <- QR(s' q), Q in f64 throughout,
// rounded to f32 once.
__global__ void __launch_bounds__(kThreads)
    top3_subspace_kernel(SubspaceArgs a) {
  // Q (kQStride n), then y (3n); Q's rows are read 16 bytes at a time
  extern __shared__ __align__(16) double sub_rows[];
  __shared__ double red[2 * kWarps * 3];
  BlockSum<3> sum(red);
  const int n = a.n;
  const size_t nn = static_cast<size_t>(n) * n;
  for (int b = blockIdx.x; b < a.n_frames; b += gridDim.x) {
    double* qs = a.scratch != nullptr
                     ? a.scratch + static_cast<size_t>(b) * 8 * n
                     : sub_rows;
    double* y = qs + kQStride * n;
    __syncthreads();  // the last frame's readers of y and Q are done
    const float* st = a.start + static_cast<size_t>(b) * n * 3;
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) y[c * n + i] = st[3 * i + c];
    householder_q(y, qs, n, sum);
    for (int step = 0; step <= a.iters; ++step) {
      __syncthreads();  // Q whole, y free
      transposed_product((step < a.iters ? a.gp : a.s) + b * nn, qs, y, n);
      householder_q(y, qs, n, sum);
    }
    float* out = a.q + static_cast<size_t>(b) * n * 3;
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[3 * i + c] = static_cast<float>(qs[i * kQStride + c]);
  }
}

// --------------------------------------------------------------- top2_span

// One Jacobi rotation of the symmetric a (3 x 3) in the (p, q) plane, and of
// the eigenvector columns v (Numerical Recipes' jacobi).
__device__ __forceinline__ void jacobi_rotate(double (&a)[3][3],
                                              double (&v)[3][3], int p,
                                              int q) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                   (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0);
  const double s = t * c;
  a[p][p] -= t * apq;
  a[q][q] += t * apq;
  a[p][q] = a[q][p] = 0.0;
  const int r = 3 - p - q;
  const double arp = a[r][p], arq = a[r][q];
  a[r][p] = a[p][r] = c * arp - s * arq;
  a[r][q] = a[q][r] = s * arp + c * arq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

// The eigenpairs of the symmetric 3 x 3 g (xx xy xz yy yz zz) by cyclic
// Jacobi: the eigenvectors of the two largest eigenvalues (columns of vec)
// and 1 / max(sqrt(max(lambda, 0)), 1e-30) of each.
__device__ __forceinline__ void top2_eigen(const double (&g)[6],
                                           double (&vec)[3][2],
                                           double (&inv_sigma)[2]) {
  double a[3][3] = {{g[0], g[1], g[2]}, {g[1], g[3], g[4]},
                    {g[2], g[4], g[5]}};
  double v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  for (int sweep = 0; sweep < 16; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] +
                       a[1][2] * a[1][2];
    const double diag = a[0][0] * a[0][0] + a[1][1] * a[1][1] +
                        a[2][2] * a[2][2];
    if (off <= 1e-32 * diag) break;
    jacobi_rotate(a, v, 0, 1);
    jacobi_rotate(a, v, 0, 2);
    jacobi_rotate(a, v, 1, 2);
  }
  int i0 = 0;
  for (int k = 1; k < 3; ++k)
    if (a[k][k] > a[i0][i0]) i0 = k;
  int i1 = i0 == 0 ? 1 : 0;
  for (int k = 0; k < 3; ++k)
    if (k != i0 && a[k][k] > a[i1][i1]) i1 = k;
  const int top[2] = {i0, i1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    for (int k = 0; k < 3; ++k) vec[k][j] = v[k][top[j]];
    inv_sigma[j] = 1.0 / fmax(sqrt(fmax(a[top[j]][top[j]], 0.0)), 1e-30);
  }
}

// Rows of u2 a span block holds in shared memory (f64) at a time for the
// Laplacian products.
constexpr int kSpanTile = 1024;

struct SpanArgs {
  const float* span;    // (B, n, 3)
  const float* degree;  // (B, n)
  const float* s;       // (B, n, n), or null: no Laplacian products
  float* u2;            // (B, n, 2)
  float* lu2;           // (B, n, 2): u2 - s' u2, with s
  int n_frames, n;
  int aligned;          // s 16-byte aligned and n % 4 == 0
};

// The frame's deflated span row i: d = span_i - v0_i c.
__device__ __forceinline__ void deflated_row(const float* span,
                                             const float* deg, int i,
                                             double inv, const double (&c)[3],
                                             double (&d)[3]) {
  const double v = sqrt(fmax(static_cast<double>(deg[i]), 0.0)) * inv;
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = span[3 * i + k] - v * c[k];
}

// Frame b's u2: v0's norm and the span's part along v0 in one block sum,
// the deflated Gram in a second, its eigenpairs in every thread, the rows
// rounded to f32 into u2 and, with uv, the same f32 values in f64 into uv
// (2 a row, shared memory).
__device__ __forceinline__ void top2_rows(const SpanArgs& a, int b,
                                          BlockSum<4>& sum4,
                                          BlockSum<6>& sum6, double* uv) {
  const int n = a.n;
  const float* span = a.span + static_cast<size_t>(b) * n * 3;
  const float* deg = a.degree + static_cast<size_t>(b) * n;
  double t[4] = {0.0, 0.0, 0.0, 0.0};  // |sqrt(deg)|^2, sqrt(deg)' span
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double d = fmax(static_cast<double>(deg[i]), 0.0);
    const double r = sqrt(d);
    t[0] += d;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      t[k + 1] = fma(r, static_cast<double>(span[3 * i + k]), t[k + 1]);
  }
  sum4(t);
  const double inv = 1.0 / fmax(sqrt(t[0]), 1e-30);
  const double c[3] = {t[1] * inv, t[2] * inv, t[3] * inv};
  double g[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double d[3];
    deflated_row(span, deg, i, inv, c, d);
    g[0] = fma(d[0], d[0], g[0]);
    g[1] = fma(d[0], d[1], g[1]);
    g[2] = fma(d[0], d[2], g[2]);
    g[3] = fma(d[1], d[1], g[3]);
    g[4] = fma(d[1], d[2], g[4]);
    g[5] = fma(d[2], d[2], g[5]);
  }
  sum6(g);
  double vec[3][2], inv_sigma[2];
  top2_eigen(g, vec, inv_sigma);
  float2* u2 = reinterpret_cast<float2*>(a.u2) + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double d[3];
    deflated_row(span, deg, i, inv, c, d);
    const float2 x = make_float2(
        static_cast<float>(
            (d[0] * vec[0][0] + d[1] * vec[1][0] + d[2] * vec[2][0]) *
            inv_sigma[0]),
        static_cast<float>(
            (d[0] * vec[0][1] + d[1] * vec[1][1] + d[2] * vec[2][1]) *
            inv_sigma[1]));
    u2[i] = x;
    if (uv != nullptr) {
      uv[2 * i] = x.x;
      uv[2 * i + 1] = x.y;
    }
  }
}

// One block a frame: u2 (`top2_rows`); then, with s, lap(u2) = u2 - s' u2
// with s' u2 by columns, as the subspace products, the matrix read
// straight from device memory and u2 (the f32 rows just written) through
// shared memory in f64 a tile at a time.
__global__ void __launch_bounds__(kThreads) top2_span_kernel(SpanArgs a) {
  constexpr int kCols = kColsAtOnce;
  __shared__ double red4[2 * kWarps * 4];
  __shared__ double red6[2 * kWarps * 6];
  __shared__ double2 tile[kSpanTile];
  const int b = blockIdx.x;
  const int n = a.n;
  BlockSum<4> sum4(red4);
  BlockSum<6> sum6(red6);
  top2_rows(a, b, sum4, sum6, nullptr);
  const float2* u2 =
      reinterpret_cast<const float2*>(a.u2) + static_cast<size_t>(b) * n;
  if (a.s == nullptr) return;  // the same in every thread
  const float* s = a.s + static_cast<size_t>(b) * n * n;
  float2* lu2 = reinterpret_cast<float2*>(a.lu2) + static_cast<size_t>(b) * n;
  constexpr int kRows = kAhead;
  // the same passes in every thread: each reloads the tiles behind barriers
  for (int base = 0; base < n; base += kCols * kThreads) {
    const int t0 = base + threadIdx.x;
    double acc[kCols][2];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k][0] = acc[k][1] = 0.0;
    for (int start = 0; start < n; start += kSpanTile) {
      const int rows = min(kSpanTile, n - start);
      __syncthreads();  // u2 written; the last tile's readers done
      for (int i = threadIdx.x; i < rows; i += kThreads) {
        const float2 x = u2[start + i];
        tile[i] = make_double2(x.x, x.y);
      }
      __syncthreads();
      for (int i0 = 0; i0 < rows; i0 += kRows) {
        float w[kRows][kCols];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int i = start + i0 + u, col = t0 + k * kThreads;
            w[u][k] = i0 + u < rows && col < n
                          ? __ldg(s + static_cast<size_t>(i) * n + col)
                          : 0.0f;
          }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (i0 + u >= rows) break;  // the same in every thread
          const double2 x = tile[i0 + u];
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const double sw = static_cast<double>(w[u][k]);
            acc[k][0] = fma(sw, x.x, acc[k][0]);
            acc[k][1] = fma(sw, x.y, acc[k][1]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = t0 + k * kThreads;
      if (col < n) {
        const float2 x = u2[col];
        lu2[col] = make_float2(static_cast<float>(x.x - acc[k][0]),
                               static_cast<float>(x.y - acc[k][1]));
      }
    }
  }
}

// top2_span with s, frames of up to kColsAtOnce * kThreads rows: persistent
// blocks, u2 (`top2_rows`, also into shared memory in f64), then s' u2
// through the ring (one pass a frame), which copies a frame's first tiles
// under its sums.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
    top2_span_ring_kernel(SpanArgs a) {
  extern __shared__ __align__(16) float ring[];  // the ring, then u2 (2n)
  __shared__ double red4[2 * kWarps * 4];
  __shared__ double red6[2 * kWarps * 6];
  BlockSum<4> sum4(red4);
  BlockSum<6> sum6(red6);
  const int n = a.n;
  double* uv = reinterpret_cast<double*>(ring + kRingStages * kStageFloats);
  TileStream ts(a.s, a.s, n, a.n_frames, 0, a.aligned != 0);
  for (int j = 0; j < kRingStages - 1; ++j) ts.issue(ring);
  int j = 0;
  for (int b = blockIdx.x; b < a.n_frames; b += gridDim.x) {
    __syncthreads();  // the last frame's readers of uv are done
    top2_rows(a, b, sum4, sum6, uv);
    float2* lu2 =
        reinterpret_cast<float2*>(a.lu2) + static_cast<size_t>(b) * n;
    // uv is whole once the product's first tile is acquired
    if constexpr (kCols == 1) {
      ring_product_wide<2, 2>(ts, j, ring, uv,
                              [&](int t, const double(&tot)[2]) {
                                lu2[t] = make_float2(
                                    static_cast<float>(uv[2 * t] - tot[0]),
                                    static_cast<float>(uv[2 * t + 1] -
                                                       tot[1]));
                              });
    } else {
      double acc[kCols][2];
      ring_product<kCols, 2, 2>(ts, j, ring, uv, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int t = threadIdx.x + c * kThreads;
        if (t < n)
          lu2[t] = make_float2(static_cast<float>(uv[2 * t] - acc[c][0]),
                               static_cast<float>(uv[2 * t + 1] - acc[c][1]));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// --------------------------------------------------------- rayleigh_kmeans

// Rows a lane of the one-warp path holds: frames of up to 256 rows.
constexpr int kWarpRows = 8;
// Frames (warps) a block of the one-warp path.
constexpr int kWarpFrames = 4;

struct KmeansArgs {
  const float2* u2;   // (B, n)
  const float2* lu2;  // (B, n): lap(u2)
  int* labels;        // (B, n)
  int* steps;         // (B,) or null: the centroid updates each frame ran
  float2* scratch;    // (B, n) when the embedding does not fit shared memory
  int n_frames, n, iters;
};

// (x - c)^2 summed over the two components, each step rounded.
__device__ __forceinline__ float dist2(float2 e, float2 c) {
  const float dx = __fsub_rn(e.x, c.x);
  const float dy = __fsub_rn(e.y, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Whether (v, r) beats (best, row): the larger distance, the lower row on
// ties.
__device__ __forceinline__ bool farther(float v, int r, float best, int row) {
  return v > best || (v == best && r < row);
}

// The farthest of the warp's candidates (best, row), in every lane.
__device__ __forceinline__ void warp_argmax(float& best, int& row) {
  for (int off = gorder::kWarpSize / 2; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(gorder::kFullWarp, best, off);
    const int r = __shfl_xor_sync(gorder::kFullWarp, row, off);
    if (farther(v, r, best, row)) {
      best = v;
      row = r;
    }
  }
}

// The energy-weighted embedding's rotation and weight, from the Rayleigh
// matrix h = (h00, h01, h11): its eigenpairs ascending by one Jacobi
// rotation, the columns q0 = (q00, q10), q1 = (q01, q11).
struct Rayleigh {
  double q00, q10, q01, q11, w;
};

__device__ __forceinline__ Rayleigh rayleigh_of(const double (&h)[3]) {
  Rayleigh r{1.0, 0.0, 0.0, 1.0, 0.0};
  double lam0 = h[0], lam1 = h[2];
  if (h[1] != 0.0) {
    const double theta = (h[2] - h[0]) / (2.0 * h[1]);
    const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                     (fabs(theta) + sqrt(theta * theta + 1.0));
    const double c = 1.0 / sqrt(t * t + 1.0);
    const double s = t * c;
    lam0 = h[0] - t * h[1];
    lam1 = h[2] + t * h[1];
    r.q00 = c;
    r.q10 = -s;
    r.q01 = s;
    r.q11 = c;
  }
  if (lam0 > lam1) {
    const double l = lam0, x = r.q00, y = r.q10;
    lam0 = lam1;
    r.q00 = r.q01;
    r.q10 = r.q11;
    lam1 = l;
    r.q01 = x;
    r.q11 = y;
  }
  r.w = sqrt(fmax(lam0, 1e-9) / fmax(lam1, 1e-9));
  return r;
}

// A row of the embedding: (x q0, w x q1), normalized where its norm >
// 1e-10, rounded to f32.
__device__ __forceinline__ float2 embed(float2 x, const Rayleigh& r) {
  double e0 = x.x * r.q00 + x.y * r.q10;
  double e1 = (x.x * r.q01 + x.y * r.q11) * r.w;
  const double norm = sqrt(e0 * e0 + e1 * e1);
  if (norm > static_cast<double>(1e-10f)) {
    e0 /= norm;
    e1 /= norm;
  }
  return make_float2(static_cast<float>(e0), static_cast<float>(e1));
}

// A cluster's centroid from its sums and count, or `first` where empty.
__device__ __forceinline__ float2 centroid(double sx, double sy, double count,
                                           float2 first) {
  return count > 0.0 ? make_float2(static_cast<float>(sx / count),
                                   static_cast<float>(sy / count))
                     : first;
}

// One warp a frame: lane l holds rows l, l + 32, ... (kWarpRows of them).
__global__ void __launch_bounds__(kWarpFrames * gorder::kWarpSize)
    kmeans_warp_kernel(KmeansArgs a) {
  const int lane = threadIdx.x % gorder::kWarpSize;
  const int b = blockIdx.x * kWarpFrames + threadIdx.x / gorder::kWarpSize;
  if (b >= a.n_frames) return;  // the whole warp
  const int n = a.n;
  const float2* u = a.u2 + static_cast<size_t>(b) * n;
  const float2* lu = a.lu2 + static_cast<size_t>(b) * n;

  // the Rayleigh matrix: each lane's rows in order, then the butterfly
  float2 x[kWarpRows];
  double h[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int i = lane + gorder::kWarpSize * k;
    x[k] = make_float2(0.0f, 0.0f);
    if (i < n) {
      const float2 l = lu[i];
      x[k] = u[i];
      h[0] += static_cast<double>(x[k].x) * l.x;
      h[1] += static_cast<double>(x[k].x) * l.y;
      h[2] += static_cast<double>(x[k].y) * l.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = warp_sum(h[k]);
  const Rayleigh r = rayleigh_of(h);

  // the embedding, in f32 for the distances and in f64 for the sums
  float2 e[kWarpRows];
  double ex[kWarpRows], ey[kWarpRows];
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    e[k] = embed(x[k], r);
    ex[k] = e[k].x;
    ey[k] = e[k].y;
  }

  // farthest-point initialization
  const float2 first = make_float2(__shfl_sync(gorder::kFullWarp, e[0].x, 0),
                                   __shfl_sync(gorder::kFullWarp, e[0].y, 0));
  float best = -1.0f;
  int row = n;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int i = lane + gorder::kWarpSize * k;
    if (i < n) {
      const float d = dist2(e[k], first);
      if (d > best) {
        best = d;
        row = i;
      }
    }
  }
  warp_argmax(best, row);
  float2 far = e[0];
#pragma unroll
  for (int k = 1; k < kWarpRows; ++k)
    if (k == row / gorder::kWarpSize) far = e[k];
  const int owner = row % gorder::kWarpSize;
  float2 c0 = first;
  float2 c1 = make_float2(__shfl_sync(gorder::kFullWarp, far.x, owner),
                          __shfl_sync(gorder::kFullWarp, far.y, owner));

  // the steps, until the labels repeat: bit k of `ones` is row l + 32 k's
  unsigned ones = 0u, before = 0u;
  int steps = a.iters;
  bool fixed = false;
  for (int it = 0; it < a.iters; ++it) {
    double s[4] = {0.0, 0.0, 0.0, 0.0};  // x0 y0 x1 y1
    int n1 = 0;
    ones = 0u;
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) {
      if (lane + gorder::kWarpSize * k >= n) continue;
      if (dist2(e[k], c1) < dist2(e[k], c0)) {
        ones |= 1u << k;
        s[2] += ex[k];
        s[3] += ey[k];
        ++n1;
      } else {
        s[0] += ex[k];
        s[1] += ey[k];
      }
    }
    if (it > 0 && !__any_sync(gorder::kFullWarp, ones != before)) {
      steps = it;
      fixed = true;
      break;
    }
    before = ones;
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = warp_sum(s[k]);
    n1 = __reduce_add_sync(gorder::kFullWarp, n1);
    c0 = centroid(s[0], s[1], static_cast<double>(n - n1), first);
    c1 = centroid(s[2], s[3], static_cast<double>(n1), first);
  }
  if (!fixed) {
    ones = 0u;
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k)
      if (dist2(e[k], c1) < dist2(e[k], c0)) ones |= 1u << k;
  }
  int* out = a.labels + static_cast<size_t>(b) * n;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int i = lane + gorder::kWarpSize * k;
    if (i < n) out[i] = (ones >> k) & 1u;
  }
  if (a.steps != nullptr && lane == 0) a.steps[b] = steps;
}

// The farthest row of the block's candidates, in every thread.
__device__ __forceinline__ int block_argmax(float best, int row,
                                            float* vals, int* rows) {
  warp_argmax(best, row);
  if ((threadIdx.x & (gorder::kWarpSize - 1)) == 0) {
    vals[threadIdx.x / gorder::kWarpSize] = best;
    rows[threadIdx.x / gorder::kWarpSize] = row;
  }
  __syncthreads();
  best = vals[0];
  row = rows[0];
  for (int w = 1; w < kWarps; ++w)
    if (farther(vals[w], rows[w], best, row)) {
      best = vals[w];
      row = rows[w];
    }
  return row;
}

// One block a frame, the rows in shared memory or `scratch`; the labels of
// the previous step in `labels`.
__global__ void __launch_bounds__(kThreads)
    kmeans_block_kernel(KmeansArgs a) {
  extern __shared__ float2 km_rows[];  // the embedding, unless scratch
  __shared__ double red3[2 * kWarps * 3];
  __shared__ double red6[2 * kWarps * 6];
  __shared__ float arg_vals[kWarps];
  __shared__ int arg_rows[kWarps];
  const int b = blockIdx.x;
  const int n = a.n;
  float2* emb = a.scratch != nullptr
                    ? a.scratch + static_cast<size_t>(b) * n
                    : km_rows;
  const float2* u = a.u2 + static_cast<size_t>(b) * n;
  const float2* lu = a.lu2 + static_cast<size_t>(b) * n;
  int* out = a.labels + static_cast<size_t>(b) * n;
  BlockSum<3> sum3(red3);
  BlockSum<6> sum6(red6);

  // the Rayleigh matrix and the energy-weighted, row-normalized embedding
  double h[3] = {0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 x = u[i], l = lu[i];
    h[0] += static_cast<double>(x.x) * l.x;
    h[1] += static_cast<double>(x.x) * l.y;
    h[2] += static_cast<double>(x.y) * l.y;
  }
  sum3(h);
  const Rayleigh r = rayleigh_of(h);
  for (int i = threadIdx.x; i < n; i += kThreads) emb[i] = embed(u[i], r);
  __syncthreads();

  // farthest-point initialization
  const float2 first = emb[0];
  float best = -1.0f;
  int row = n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = dist2(emb[i], first);
    if (d > best) {
      best = d;
      row = i;
    }
  }
  float2 c0 = first, c1 = emb[block_argmax(best, row, arg_vals, arg_rows)];

  // the steps, until no label changes; the changed labels ride the sums
  int steps = a.iters;
  bool fixed = false;
  for (int it = 0; it < a.iters; ++it) {
    double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // x0 y0 x1 y1 n1 changed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 e = emb[i];
      const int one = dist2(e, c1) < dist2(e, c0) ? 1 : 0;
      if (one) {
        s[2] += e.x;
        s[3] += e.y;
        s[4] += 1.0;
      } else {
        s[0] += e.x;
        s[1] += e.y;
      }
      if (it > 0 && out[i] != one) s[5] += 1.0;
      out[i] = one;
    }
    sum6(s);
    if (it > 0 && s[5] == 0.0) {  // the same in every thread
      steps = it;
      fixed = true;
      break;
    }
    c0 = centroid(s[0], s[1], n - s[4], first);
    c1 = centroid(s[2], s[3], s[4], first);
  }
  if (!fixed)
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 e = emb[i];
      out[i] = dist2(e, c1) < dist2(e, c0) ? 1 : 0;
    }
  if (a.steps != nullptr && threadIdx.x == 0) a.steps[b] = steps;
}

// The triangle kernel's grid on the current device: as many blocks as its
// SMs hold at once with `bytes` of shared memory each, after the opt-in to
// those bytes. Both are per device; they are found on a device's first
// launch at a size and kept in its slot, as bytes << 20 | blocks.
constexpr int kMaxDevices = 64;
std::atomic<unsigned long long> triangle_grids[2][kMaxDevices];

template <bool kPbc>
cudaError_t triangle_grid(size_t bytes, int& blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<unsigned long long>* slot =
      device < kMaxDevices ? &triangle_grids[kPbc][device] : nullptr;
  if (slot != nullptr) {
    const unsigned long long kept = slot->load(std::memory_order_acquire);
    if (kept >> 20 == bytes) {
      blocks = static_cast<int>(kept & 0xfffff);
      return cudaSuccess;
    }
  }
  const auto kernel = affinity_triangle_kernel<kPbc>;
  int sms = 0, per_sm = 0;
  err = gorder::allow_shared(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTriThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  blocks = per_sm * sms;
  if (slot != nullptr)
    slot->store(static_cast<unsigned long long>(bytes) << 20 |
                    static_cast<unsigned long long>(blocks),
                std::memory_order_release);
  return cudaSuccess;
}

// Launches a persistent kernel (top3_subspace's, top2_span's ring) with as
// many blocks as the device's SMs hold at once with `bytes` of shared
// memory each, and no more than frames.
template <class Kernel, class Args>
cudaError_t persistent_launch(Kernel kernel, const Args& a, size_t bytes,
                              cudaStream_t st) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = gorder::allow_shared(kernel, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int blocks = a.n_frames < per_sm * sms ? a.n_frames : per_sm * sms;
  kernel<<<blocks, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream`, one block (or, for
// rayleigh_kmeans' warp path, one warp) a frame, or persistent blocks that
// take frame after frame (spectral_affinity's triangle, top3_subspace),
// and returns the first error (0 = launched); the outputs are written
// whole. A null scratch asks for the working rows in shared memory, which
// must then fit (top3_subspace: 56 bytes a row, up to kMaxShared;
// rayleigh_kmeans: 8, up to kMaxDynamic).

// heads (B, n, 3) f32, box (B, 3) f32 (read with pbc only) -> s (B, n, n)
// f32 and degree (B, n) f32: with `triangle` the triangle path (its shared
// memory, triangle_bytes(n), at most 227 KiB); else two passes, `tile`
// heads a shared-memory tile (16 bytes a head, at most kMaxDynamic).
int spectral_affinity(const void* heads, const void* box, void* s,
                      void* degree, int n_frames, int n, float sigma, int pbc,
                      int triangle, int tile, void* stream) {
  if (n_frames < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = triangle ? triangle_bytes(n)
                                : 4 * sizeof(float) * static_cast<size_t>(tile);
  if (triangle ? bytes > kMaxShared : (tile <= 0 || bytes > kMaxDynamic))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n == 0) return 0;
  const AffinityArgs a{static_cast<const float*>(heads),
                       static_cast<const float*>(box),
                       static_cast<float*>(s),
                       static_cast<float*>(degree),
                       n_frames,
                       n,
                       tile,
                       sigma};
  const auto st = static_cast<cudaStream_t>(stream);
  if (triangle) {  // as many blocks as the card holds at once, or frames
    int blocks = 0;
    const cudaError_t err = pbc ? triangle_grid<true>(bytes, blocks)
                                : triangle_grid<false>(bytes, blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > n_frames) blocks = n_frames;
    if (pbc)
      affinity_triangle_kernel<true><<<blocks, kTriThreads, bytes, st>>>(a);
    else
      affinity_triangle_kernel<false><<<blocks, kTriThreads, bytes, st>>>(a);
  } else if (pbc) {
    affinity_kernel<true><<<n_frames, kThreads, bytes, st>>>(a);
  } else {
    affinity_kernel<false><<<n_frames, kThreads, bytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// gp, s (B, n, n) f32 and start (B, n, 3) f32, n >= 3 -> q (B, n, 3) f32.
// With `ring` (n <= kColsAtOnce * kThreads) the matrices stream through
// the ring, Q and y in shared memory beside it (kRingBytes + 56n bytes);
// else with a null scratch each block's Q and y in shared memory (56n
// bytes), or in scratch (B, 8n) f64. The static sums take their bytes too,
// all at most kMaxShared. As many persistent blocks as the SMs hold, and
// no more than frames.
int top3_subspace(const void* gp, const void* s, const void* start, void* q,
                  void* scratch, int n_frames, int n, int iters, int ring,
                  void* stream) {
  const size_t rows = (kQStride + 3) * sizeof(double) * static_cast<size_t>(n);
  const size_t bytes = ring ? kRingBytes + rows : scratch != nullptr ? 0 : rows;
  if (n_frames < 0 || n < 3 || iters < 0 ||
      (ring && (scratch != nullptr || n > kColsAtOnce * kThreads)) ||
      bytes + 2 * kWarps * 3 * sizeof(double) > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0) return 0;
  const bool aligned = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(gp) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const SubspaceArgs a{static_cast<const float*>(gp),
                       static_cast<const float*>(s),
                       static_cast<const float*>(start),
                       static_cast<float*>(q),
                       static_cast<double*>(scratch),
                       n_frames,
                       n,
                       iters,
                       aligned ? 1 : 0};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !ring ? persistent_launch(top3_subspace_kernel, a, bytes, st)
      : n <= kThreads
          ? persistent_launch(top3_subspace_ring_kernel<1>, a, bytes, st)
          : persistent_launch(top3_subspace_ring_kernel<kColsAtOnce>, a, bytes,
                              st);
  return static_cast<int>(err);
}

// span (B, n, 3) f32, degree (B, n) f32 and s (B, n, n) f32 or null -> u2
// (B, n, 2) f32 and, with s, lu2 (B, n, 2) f32: with s and n <=
// kColsAtOnce * kThreads persistent blocks and the ring (kRingBytes + 16n
// bytes of shared memory), else one block a frame.
int top2_span(const void* span, const void* degree, const void* s, void* u2,
              void* lu2, int n_frames, int n, void* stream) {
  if (n_frames < 0 || n < 0 || (s != nullptr && lu2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n == 0) return 0;
  const SpanArgs a{static_cast<const float*>(span),
                   static_cast<const float*>(degree),
                   static_cast<const float*>(s),
                   static_cast<float*>(u2),
                   static_cast<float*>(lu2),
                   n_frames,
                   n,
                   n % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0};
  const auto st = static_cast<cudaStream_t>(stream);
  if (s != nullptr && n <= kColsAtOnce * kThreads) {
    const size_t bytes = kRingBytes + 2 * sizeof(double) * n;
    return static_cast<int>(
        n <= kThreads
            ? persistent_launch(top2_span_ring_kernel<1>, a, bytes, st)
            : persistent_launch(top2_span_ring_kernel<kColsAtOnce>, a, bytes,
                                st));
  }
  top2_span_kernel<<<n_frames, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// u2 (B, n, 2) f32, lu2 (B, n, 2) f32, n >= 1 -> labels (B, n) int32 and,
// unless null, steps (B,) int32: with `warp` one warp a frame (n <= 256);
// else one block a frame, its rows in shared memory (scratch null) or in
// scratch (B, n, 2) f32.
int rayleigh_kmeans(const void* u2, const void* lu2, void* labels,
                    void* steps, void* scratch, int n_frames, int n,
                    int iters, int warp, void* stream) {
  const size_t bytes = warp || scratch != nullptr
                           ? 0
                           : sizeof(float2) * static_cast<size_t>(n);
  if (n_frames < 0 || n < 1 || iters < 0 || bytes > kMaxDynamic ||
      (warp && n > kWarpRows * gorder::kWarpSize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0) return 0;
  const KmeansArgs a{static_cast<const float2*>(u2),
                     static_cast<const float2*>(lu2),
                     static_cast<int*>(labels),
                     static_cast<int*>(steps),
                     static_cast<float2*>(scratch),
                     n_frames,
                     n,
                     iters};
  const auto st = static_cast<cudaStream_t>(stream);
  if (warp)
    kmeans_warp_kernel<<<(n_frames + kWarpFrames - 1) / kWarpFrames,
                         kWarpFrames * gorder::kWarpSize, 0, st>>>(a);
  else
    kmeans_block_kernel<<<n_frames, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The spectral leaflet classifier's per-frame passes for Hopper (sm_90a):
// the similarity matrix, the thin QR of an n x 3 basis, the two leading
// directions of the deflated span, and the energy-weighted embedding with
// its 100-step k-means.
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
// the min-imaged d = p_i - p_j, the degree deg_i = sum_j w_ij (f64, rounded
// once), dis_i = 1 / sqrt(deg_i) where deg_i > 1e-10 (else 0), and S_ij =
// (w_ij * dis_i) * dis_j. Every f32 step is an _rn intrinsic and expf is
// compiled without fast math, so w is the plain version's; d2 is symmetric
// bit for bit (the minimum image is odd), so deg_j = sum_i w_ij. One block a
// frame: pass 1 gives each thread a column j and sums its weights, pass 2
// writes row after row, each thread its column, so that the rows' stores
// coalesce. The heads go through shared memory in tiles.
//
// thin_qr3: per frame, A (n, 3) f32 -> Q (n, 3) f32 with orthonormal
// columns, span(Q[:, :k]) = span(A[:, :k]): three Householder reflections
// v = x - alpha e_k, alpha = -sign(x_0) |x|, v'v = 2 |x| (|x| + |x_0|),
// applied to the later columns and then, in reverse, to the first three
// columns of the identity, all in f64 (an input after the filter's 12
// squarings has a condition number near 5e7: classical Gram-Schmidt and
// Cholesky-QR lose its orthogonality in f32). A reflection of a zero
// column is skipped (LAPACK's tau = 0). Working columns in shared memory
// (48 bytes a row), or in a scratch buffer in device memory for large n.
//
// top2_span: per frame, the (n, 3) span and the degree -> (n, 2): v0 =
// sqrt(max(deg, 0)) / max(|.|, 1e-30), the deflated D = span - v0 (v0'
// span), its 3 x 3 Gram D'D, whose eigenpairs come from cyclic Jacobi in
// registers (every thread the same), and U_k = D V_k / max(sigma_k,
// 1e-30) for the two largest sigma_k = sqrt(lambda_k): the two leading
// left singular vectors. The third direction (sigma ~ 0 after deflation)
// is never formed. All in f64.
//
// rayleigh_kmeans: per frame, u2 (n, 2) and its Laplacian products lap(u2)
// (n, 2) -> (n,) int32 labels. The 2 x 2 Rayleigh matrix h = u2' lap(u2)
// (h01 = a' lap(b)) in f64 and its eigenpairs ascending (one Jacobi
// rotation), the weight w = sqrt(max(l0, 1e-9) / max(l1, 1e-9)), the rows
// (u2 q0, w u2 q1) normalized where their norm > 1e-10, rounded to f32 and
// kept in shared memory (or a scratch buffer); then k-means, k = 2: c0 =
// row 0, c1 = the row farthest from it (the lowest row on ties, as
// torch.argmax), `iters` steps of labels d1 < d0 (f32 squared distances,
// _rn) and centroids from f64 block sums, a cluster left empty falling back
// to row 0, and the final labels d1 < d0.
//
// What bounds them on this card: at the clustering benchmark's 256 heads,
// none of them its bytes or operations. spectral_affinity writes S, 256 KB
// a frame, and is bound by those bytes; the other three touch 16 to 24
// bytes a row, and their time is the latency of their block reductions (8
// in thin_qr3, 4 in top2_span, 102 in rayleigh_kmeans), a few microseconds
// each. What the design does about it: one launch a batch of frames, one
// block a frame, every reduction in the block (warp shuffles and one
// barrier), where cuSOLVER took several launches a matrix and torch's
// k-means some 2,000 a call.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / gorder::kWarpSize;
// The dynamic shared memory a block may take without opting in, less the
// static buffers of the reductions.
constexpr size_t kMaxDynamic = 40 * 1024;

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

// ------------------------------------------------------- spectral_affinity

struct AffinityArgs {
  const float* heads;  // (B, n, 3)
  const float* box;    // (B, 3)
  float* s;            // (B, n, n)
  float* degree;       // (B, n)
  int n, tile;
  float sigma;
};

// exp(-sigma * d2) of the min-imaged p - q, d2 summed x, y, z in order.
template <bool kPbc>
__device__ __forceinline__ float weight(float px, float py, float pz,
                                        float3 q, float3 L, float sigma) {
  float dx = __fsub_rn(px, q.x);
  float dy = __fsub_rn(py, q.y);
  float dz = __fsub_rn(pz, q.z);
  if (kPbc) {
    dx = gorder::min_image(dx, L.x);
    dy = gorder::min_image(dy, L.y);
    dz = gorder::min_image(dz, L.z);
  }
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return expf(__fmul_rn(-sigma, d2));
}

// 1 / sqrt(deg) where deg > 1e-10, else 0 (the plain version's guard).
__device__ __forceinline__ float inv_sqrt_degree(float deg) {
  return deg > 1e-10f ? __fdiv_rn(1.0f, __fsqrt_rn(deg)) : 0.0f;
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
  const float3 L = make_float3(a.box[3 * b], a.box[3 * b + 1],
                               a.box[3 * b + 2]);
  float* deg = a.degree + static_cast<size_t>(b) * n;
  float* s = a.s + static_cast<size_t>(b) * n * n;
  const float* tx = aff_tile;
  const float* ty = aff_tile + a.tile;
  const float* tz = aff_tile + 2 * a.tile;
  const float* td = aff_tile + 3 * a.tile;

  // pass 1: each thread a column j, its weights summed in f64 in row order
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool active = j < n;
    const float3 q = active ? make_float3(p[3 * j], p[3 * j + 1], p[3 * j + 2])
                            : make_float3(0.0f, 0.0f, 0.0f);
    double acc = 0.0;
    for (int start = 0; start < n; start += a.tile) {
      const int m = min(a.tile, n - start);
      __syncthreads();
      load_heads(aff_tile, p, nullptr, start, m, a.tile);
      __syncthreads();
      if (!active) continue;
      for (int c = 0; c < m; ++c)
        acc += weight<kPbc>(tx[c], ty[c], tz[c], q, L, a.sigma);
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
        const float w = weight<kPbc>(tx[c], ty[c], tz[c], q, L, a.sigma);
        row[static_cast<size_t>(c) * n] =
            __fmul_rn(__fmul_rn(w, td[c]), dis_j);
      }
    }
  }
}

// ---------------------------------------------------------------- thin_qr3

struct QrArgs {
  const float* a;   // (B, n, 3)
  float* q;         // (B, n, 3)
  double* scratch;  // (B, 6n) when the columns do not fit shared memory
  int n;
};

__global__ void __launch_bounds__(kThreads) thin_qr3_kernel(QrArgs args) {
  extern __shared__ double qr_cols[];  // A (3n) and Q (3n), column-major
  __shared__ double red[2 * kWarps * 3];
  const int b = blockIdx.x;
  const int n = args.n;
  double* A = args.scratch != nullptr
                  ? args.scratch + static_cast<size_t>(b) * 6 * n
                  : qr_cols;
  double* Q = A + 3 * n;
  const float* in = args.a + static_cast<size_t>(b) * n * 3;
  // each thread owns the rows i = threadIdx.x (mod kThreads) throughout
  for (int i = threadIdx.x; i < n; i += kThreads)
    for (int c = 0; c < 3; ++c) {
      A[c * n + i] = in[3 * i + c];
      Q[c * n + i] = i == c ? 1.0 : 0.0;
    }
  BlockSum<3> sum(red);
  // reflector k: v_k = x_k (its first entry) and A[k, i] below; 2 / v'v
  double head[3], scale[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double t[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < n; i += kThreads)
      if (i >= k) t[0] += A[k * n + i] * A[k * n + i];
    sum(t);
    const double norm = sqrt(t[0]);
    const double x0 = A[k * n + k];
    const double alpha = x0 >= 0.0 ? -norm : norm;
    const double vv = 2.0 * norm * (norm + fabs(x0));
    head[k] = x0 - alpha;
    scale[k] = vv > 0.0 ? 2.0 / vv : 0.0;
    if (k == 2 || scale[k] == 0.0) continue;  // the same in every thread
    double d[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i < k) continue;
      const double v = i == k ? head[k] : A[k * n + i];
      for (int c = k + 1; c < 3; ++c) d[c] += v * A[c * n + i];
    }
    sum(d);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i < k) continue;
      const double v = i == k ? head[k] : A[k * n + i];
      for (int c = k + 1; c < 3; ++c) A[c * n + i] -= scale[k] * d[c] * v;
    }
  }
  // Q = H0 H1 H2 [I; 0]: the reflections applied in reverse
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    if (scale[k] == 0.0) continue;
    double d[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i < k) continue;
      const double v = i == k ? head[k] : A[k * n + i];
      for (int c = 0; c < 3; ++c) d[c] += v * Q[c * n + i];
    }
    sum(d);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i < k) continue;
      const double v = i == k ? head[k] : A[k * n + i];
      for (int c = 0; c < 3; ++c) Q[c * n + i] -= scale[k] * d[c] * v;
    }
  }
  float* out = args.q + static_cast<size_t>(b) * n * 3;
  for (int i = threadIdx.x; i < n; i += kThreads)
    for (int c = 0; c < 3; ++c) out[3 * i + c] = static_cast<float>(Q[c * n + i]);
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

struct SpanArgs {
  const float* span;    // (B, n, 3)
  const float* degree;  // (B, n)
  float* u2;            // (B, n, 2)
  int n;
};

__global__ void __launch_bounds__(kThreads) top2_span_kernel(SpanArgs a) {
  __shared__ double red[2 * kWarps * 6];
  const int b = blockIdx.x;
  const int n = a.n;
  const float* span = a.span + static_cast<size_t>(b) * n * 3;
  const float* deg = a.degree + static_cast<size_t>(b) * n;
  BlockSum<6> sum(red);
  double t[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads)
    t[0] += fmax(static_cast<double>(deg[i]), 0.0);  // sqrt(.) squared
  sum(t);
  const double inv = 1.0 / fmax(sqrt(t[0]), 1e-30);
  double c[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double v = sqrt(fmax(static_cast<double>(deg[i]), 0.0)) * inv;
    for (int k = 0; k < 3; ++k) c[k] += v * span[3 * i + k];
  }
  sum(c);
  double g[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double v = sqrt(fmax(static_cast<double>(deg[i]), 0.0)) * inv;
    const double d0 = span[3 * i] - v * c[0];
    const double d1 = span[3 * i + 1] - v * c[1];
    const double d2 = span[3 * i + 2] - v * c[2];
    g[0] += d0 * d0;
    g[1] += d0 * d1;
    g[2] += d0 * d2;
    g[3] += d1 * d1;
    g[4] += d1 * d2;
    g[5] += d2 * d2;
  }
  sum(g);
  double vec[3][2], inv_sigma[2];
  top2_eigen(g, vec, inv_sigma);
  float* out = a.u2 + static_cast<size_t>(b) * n * 2;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double v = sqrt(fmax(static_cast<double>(deg[i]), 0.0)) * inv;
    const double d0 = span[3 * i] - v * c[0];
    const double d1 = span[3 * i + 1] - v * c[1];
    const double d2 = span[3 * i + 2] - v * c[2];
    for (int j = 0; j < 2; ++j)
      out[2 * i + j] = static_cast<float>(
          (d0 * vec[0][j] + d1 * vec[1][j] + d2 * vec[2][j]) * inv_sigma[j]);
  }
}

// --------------------------------------------------------- rayleigh_kmeans

struct KmeansArgs {
  const float2* u2;   // (B, n)
  const float2* lu2;  // (B, n): lap(u2)
  int* labels;        // (B, n)
  float2* scratch;    // (B, n) when the embedding does not fit shared memory
  int n, iters;
};

// (x - c)^2 summed over the two components, each step rounded.
__device__ __forceinline__ float dist2(float2 e, float2 c) {
  const float dx = __fsub_rn(e.x, c.x);
  const float dy = __fsub_rn(e.y, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The row farthest from `first`: the largest d, the lowest row on ties.
__device__ __forceinline__ int block_argmax(float best, int row,
                                            float* vals, int* rows) {
  for (int off = gorder::kWarpSize / 2; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(gorder::kFullWarp, best, off);
    const int r = __shfl_xor_sync(gorder::kFullWarp, row, off);
    if (v > best || (v == best && r < row)) {
      best = v;
      row = r;
    }
  }
  if ((threadIdx.x & (gorder::kWarpSize - 1)) == 0) {
    vals[threadIdx.x / gorder::kWarpSize] = best;
    rows[threadIdx.x / gorder::kWarpSize] = row;
  }
  __syncthreads();
  best = vals[0];
  row = rows[0];
  for (int w = 1; w < kWarps; ++w)
    if (vals[w] > best || (vals[w] == best && rows[w] < row)) {
      best = vals[w];
      row = rows[w];
    }
  return row;
}

__global__ void __launch_bounds__(kThreads)
    rayleigh_kmeans_kernel(KmeansArgs a) {
  extern __shared__ float2 km_rows[];  // the embedding, unless scratch
  __shared__ double red[2 * kWarps * 5];
  __shared__ float arg_vals[kWarps];
  __shared__ int arg_rows[kWarps];
  const int b = blockIdx.x;
  const int n = a.n;
  float2* emb = a.scratch != nullptr
                    ? a.scratch + static_cast<size_t>(b) * n
                    : km_rows;
  const float2* u = a.u2 + static_cast<size_t>(b) * n;
  const float2* lu = a.lu2 + static_cast<size_t>(b) * n;
  BlockSum<5> sum(red);

  // the Rayleigh matrix and its eigenpairs, ascending
  double h[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 x = u[i], l = lu[i];
    h[0] += static_cast<double>(x.x) * l.x;
    h[1] += static_cast<double>(x.x) * l.y;
    h[2] += static_cast<double>(x.y) * l.y;
  }
  sum(h);
  double lam0 = h[0], lam1 = h[2];
  double q00 = 1.0, q10 = 0.0, q01 = 0.0, q11 = 1.0;  // columns q0, q1
  if (h[1] != 0.0) {
    const double theta = (h[2] - h[0]) / (2.0 * h[1]);
    const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                     (fabs(theta) + sqrt(theta * theta + 1.0));
    const double c = 1.0 / sqrt(t * t + 1.0);
    const double s = t * c;
    lam0 = h[0] - t * h[1];
    lam1 = h[2] + t * h[1];
    q00 = c;
    q10 = -s;
    q01 = s;
    q11 = c;
  }
  if (lam0 > lam1) {
    const double l = lam0, x = q00, y = q10;
    lam0 = lam1;
    q00 = q01;
    q10 = q11;
    lam1 = l;
    q01 = x;
    q11 = y;
  }
  const double w = sqrt(fmax(lam0, 1e-9) / fmax(lam1, 1e-9));

  // the energy-weighted, row-normalized embedding
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 x = u[i];
    double e0 = x.x * q00 + x.y * q10;
    double e1 = (x.x * q01 + x.y * q11) * w;
    const double norm = sqrt(e0 * e0 + e1 * e1);
    if (norm > static_cast<double>(1e-10f)) {
      e0 /= norm;
      e1 /= norm;
    }
    emb[i] = make_float2(static_cast<float>(e0), static_cast<float>(e1));
  }
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

  for (int it = 0; it < a.iters; ++it) {
    double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};  // x0 y0 x1 y1 n1
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 e = emb[i];
      if (dist2(e, c1) < dist2(e, c0)) {
        s[2] += e.x;
        s[3] += e.y;
        s[4] += 1.0;
      } else {
        s[0] += e.x;
        s[1] += e.y;
      }
    }
    sum(s);
    const double n1 = s[4], n0 = n - n1;
    c0 = n0 > 0.0 ? make_float2(static_cast<float>(s[0] / n0),
                                static_cast<float>(s[1] / n0))
                  : first;
    c1 = n1 > 0.0 ? make_float2(static_cast<float>(s[2] / n1),
                                static_cast<float>(s[3] / n1))
                  : first;
  }
  int* out = a.labels + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 e = emb[i];
    out[i] = dist2(e, c1) < dist2(e, c0) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream`, one block a frame, and
// returns the first error (0 = launched); the outputs are written whole.
// A null scratch asks for the working rows in shared memory, which must
// then fit in kMaxDynamic (thin_qr3: 48 bytes a row; rayleigh_kmeans: 8).

// heads (B, n, 3) f32, box (B, 3) f32 (read with pbc only) -> s (B, n, n)
// f32 and degree (B, n) f32; tile heads a shared-memory tile (16 bytes a
// head).
int spectral_affinity(const void* heads, const void* box, void* s,
                      void* degree, int n_frames, int n, float sigma, int pbc,
                      int tile, void* stream) {
  const size_t bytes = 4 * sizeof(float) * static_cast<size_t>(tile);
  if (n_frames < 0 || n < 0 || tile <= 0 || bytes > kMaxDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n == 0) return 0;
  const AffinityArgs a{static_cast<const float*>(heads),
                       static_cast<const float*>(box),
                       static_cast<float*>(s),
                       static_cast<float*>(degree),
                       n,
                       tile,
                       sigma};
  const auto st = static_cast<cudaStream_t>(stream);
  if (pbc)
    affinity_kernel<true><<<n_frames, kThreads, bytes, st>>>(a);
  else
    affinity_kernel<false><<<n_frames, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// a (B, n, 3) f32, n >= 3 -> q (B, n, 3) f32; scratch null or (B, 6n) f64.
int thin_qr3(const void* a, void* q, void* scratch, int n_frames, int n,
             void* stream) {
  const size_t bytes =
      scratch != nullptr ? 0 : 6 * sizeof(double) * static_cast<size_t>(n);
  if (n_frames < 0 || n < 3 || bytes > kMaxDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0) return 0;
  const QrArgs args{static_cast<const float*>(a), static_cast<float*>(q),
                    static_cast<double*>(scratch), n};
  thin_qr3_kernel<<<n_frames, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// span (B, n, 3) f32, degree (B, n) f32 -> u2 (B, n, 2) f32.
int top2_span(const void* span, const void* degree, void* u2, int n_frames,
              int n, void* stream) {
  if (n_frames < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n == 0) return 0;
  const SpanArgs a{static_cast<const float*>(span),
                   static_cast<const float*>(degree), static_cast<float*>(u2),
                   n};
  top2_span_kernel<<<n_frames, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// u2 (B, n, 2) f32, lu2 (B, n, 2) f32, n >= 1 -> labels (B, n) int32;
// scratch null or (B, n, 2) f32.
int rayleigh_kmeans(const void* u2, const void* lu2, void* labels,
                    void* scratch, int n_frames, int n, int iters,
                    void* stream) {
  const size_t bytes =
      scratch != nullptr ? 0 : sizeof(float2) * static_cast<size_t>(n);
  if (n_frames < 0 || n < 1 || iters < 0 || bytes > kMaxDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0) return 0;
  const KmeansArgs a{static_cast<const float2*>(u2),
                     static_cast<const float2*>(lu2),
                     static_cast<int*>(labels),
                     static_cast<float2*>(scratch),
                     n,
                     iters};
  rayleigh_kmeans_kernel<<<n_frames, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

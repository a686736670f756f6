// Authorized squared-L2 top-k scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/l2_topk/kernel.py::_l2_topk_kernel
// (launched by l2_topk_pallas, top-k helper _extract_topk).  Same function:
// dist = (|q|^2 + |v|^2) - 2 q.v in float32; a row is a candidate iff its W
// auth words intersect the query's role words in some word, row < n,
// dist < bound[b] (strict), and, when P > 0, every attribute word passes
// (attr & req) == req and (attr & forbid) == 0.  The k smallest candidates
// per query come back sorted by (dist, id); empty slots are +inf / -1.
//
// What bounds it on an H100: at B = 64 queries the scan is 2*B*N*d float32
// FMA operations against 4*N*d bytes of database, 32 operations per byte,
// above the card's float32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, about
// 20): it is bound by FMA throughput.  At small B the same bytes feed few
// operations and HBM bandwidth bounds it.
//
// What the design does about that:
//   * The Pallas grid walks the db tiles in order and carries the running
//     top-k in a revisited output block.  Here kernel A (l2_topk_partial)
//     splits the N rows into S contiguous ranges across the grid's y axis,
//     so even one query fills the 132 SMs; each CTA keeps its own top-k and
//     kernel B (l2_topk_merge) merges the S sorted partials, one warp per
//     query.
//   * db rows are staged through shared memory in (128 rows x 32 columns)
//     chunks with 16-byte loads; each thread then computes a 4-query x
//     2-row register tile, reading queries as broadcast float4s and rows as
//     conflict-free float4s (row stride 36 floats), so shared-memory traffic
//     stays below the FMA rate.  Query tiles of one split run side by side,
//     so a db range comes from HBM once and from L2 for the other tiles.
//   * No tensor cores, no TF32: every product is a float32 FMA, so results
//     match a float32 reference.
//   * Selection: per query, a sorted list of k (dist, id) pairs in shared
//     memory.  A warp ballots the tile's candidates below the current k-th
//     entry and inserts them one at a time (warp-parallel rank + shift);
//     once the list is full, few candidates pass, so the FMA loop dominates.
//   * No padding copies: ragged query rows and db rows are masked in-kernel.
//   * W (auth words, 1..8) and P (predicate words, 0..4) are template
//     parameters, so P = 0 carries no predicate code.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;           // queries per CTA
constexpr int TN = 128;          // db rows per tile
constexpr int DK = 32;           // feature columns per staged chunk
constexpr int DKS = DK + 4;      // shared row stride of a staged chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 128;
constexpr int MAX_SPLITS = 256;
constexpr int MAX_W = 8;
constexpr int MAX_P = 4;
constexpr int MERGE_WARPS = 4;
constexpr int ID_NONE = 0x7fffffff;  // empty slot: sorts after every id
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == 4 * 64, "thread tile: 4 query groups x 64 rows");
static_assert(BQ == 16 && TN == 128, "thread tile covers 16 queries x 128 rows");

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (xd, xi) into the sorted list (Ld, Li) of length k; the caller has
// checked that it sorts before the last entry.  All 32 lanes take part.
__device__ __forceinline__ void warp_insert(float* Ld, int* Li, int k,
                                            float xd, int xi, int lane) {
  float vd[KMAX / 32];
  int vi[KMAX / 32];
  int pos = 0;
#pragma unroll
  for (int u = 0; u < KMAX / 32; ++u) {
    const int p = lane + 32 * u;
    vd[u] = INFINITY;
    vi[u] = ID_NONE;
    if (p < k) {
      vd[u] = Ld[p];
      vi[u] = Li[p];
    }
    pos += __popc(__ballot_sync(FULL, p < k && lex_less(vd[u], vi[u], xd, xi)));
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KMAX / 32; ++u) {
    const int p = lane + 32 * u;
    if (p >= pos && p + 1 < k) {
      Ld[p + 1] = vd[u];
      Li[p + 1] = vi[u];
    }
  }
  if (lane == 0) {
    Ld[pos] = xd;
    Li[pos] = xi;
  }
  __syncwarp();
}

struct Args {
  const float* q;        // (B, d)
  const float* db;       // (N, d)
  const float* dbn;      // (N,)   |v|^2
  const uint32_t* auth;  // (W, N) word-major
  const uint32_t* role;  // (B, W)
  const float* bound;    // (B,)
  const uint32_t* attr;  // (P, N) or null
  const uint32_t* req;   // (B, P) or null
  const uint32_t* forb;  // (B, P) or null
  int B, N, d, dpad, k, S, chunk;
  bool vec;              // d % 4 == 0 and db 16-byte aligned
  float* part_d;         // (B, S, k)
  int* part_i;           // (B, S, k)
  float* out_d;          // (B, k)
  int* out_i;            // (B, k)
};

template <int W, int P>
__global__ void __launch_bounds__(THREADS, 2)
l2_topk_partial(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // BQ x dpad, zero padded
  float* dbs = qs + BQ * a.dpad;              // TN x DKS
  float* dist = dbs + TN * DKS;               // BQ x TN
  float* list_d = dist + BQ * TN;             // BQ x k
  int* list_i = reinterpret_cast<int*>(list_d + BQ * a.k);  // BQ x k
  __shared__ float qn_s[BQ];
  __shared__ float bnd_s[BQ];
  __shared__ uint32_t role_s[BQ * W];
  __shared__ uint32_t req_s[BQ * (P > 0 ? P : 1)];
  __shared__ uint32_t forb_s[BQ * (P > 0 ? P : 1)];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int s = blockIdx.y;
  const int row_begin = s * a.chunk;
  const int row_end = min(a.N, row_begin + a.chunk);
  const int k = a.k, dpad = a.dpad, d = a.d;

  for (int e = tid; e < BQ * dpad; e += THREADS) {
    const int qi = e / dpad, c = e - qi * dpad, qg = q0 + qi;
    qs[e] = (qg < a.B && c < d) ? a.q[(size_t)qg * d + c] : 0.f;
  }
  for (int e = tid; e < BQ * W; e += THREADS) {
    const int qg = q0 + e / W;
    role_s[e] = qg < a.B ? a.role[(size_t)q0 * W + e] : 0u;
  }
  if (P > 0) {
    for (int e = tid; e < BQ * P; e += THREADS) {
      const int qg = q0 + e / (P > 0 ? P : 1);
      req_s[e] = qg < a.B ? a.req[(size_t)q0 * P + e] : 0u;
      forb_s[e] = qg < a.B ? a.forb[(size_t)q0 * P + e] : 0u;
    }
  }
  if (tid < BQ) bnd_s[tid] = q0 + tid < a.B ? a.bound[q0 + tid] : -INFINITY;
  for (int e = tid; e < BQ * k; e += THREADS) {
    list_d[e] = INFINITY;
    list_i[e] = ID_NONE;
  }
  __syncthreads();
  for (int qi = warp; qi < BQ; qi += WARPS) {
    float acc = 0.f;
    for (int c = lane; c < dpad; c += 32) acc = fmaf(qs[qi * dpad + c], qs[qi * dpad + c], acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) qn_s[qi] = acc;
  }
  __syncthreads();

  const int rg = tid & 63;          // this thread's rows: rg and rg + 64
  const int qb = (tid >> 6) * 4;    // this thread's queries: qb .. qb + 3

  for (int t0 = row_begin; t0 < row_end; t0 += TN) {
    float acc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;

    for (int c0 = 0; c0 < dpad; c0 += DK) {
      if (a.vec) {
        for (int f = tid; f < TN * DK / 4; f += THREADS) {
          const int r = f >> 3, cq = (f & 7) * 4, row = t0 + r, col = c0 + cq;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < row_end && col < d)
            v = *reinterpret_cast<const float4*>(a.db + (size_t)row * d + col);
          *reinterpret_cast<float4*>(dbs + r * DKS + cq) = v;
        }
      } else {
        for (int f = tid; f < TN * DK; f += THREADS) {
          const int r = f >> 5, c = f & 31, row = t0 + r, col = c0 + c;
          dbs[r * DKS + c] = (row < row_end && col < d) ? a.db[(size_t)row * d + col] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < DK; c += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(dbs + rg * DKS + c);
        const float4 v1 = *reinterpret_cast<const float4*>(dbs + (rg + 64) * DKS + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 u = *reinterpret_cast<const float4*>(qs + (qb + j) * dpad + c0 + c);
          acc[j][0] = fmaf(u.x, v0.x, acc[j][0]);
          acc[j][0] = fmaf(u.y, v0.y, acc[j][0]);
          acc[j][0] = fmaf(u.z, v0.z, acc[j][0]);
          acc[j][0] = fmaf(u.w, v0.w, acc[j][0]);
          acc[j][1] = fmaf(u.x, v1.x, acc[j][1]);
          acc[j][1] = fmaf(u.y, v1.y, acc[j][1]);
          acc[j][1] = fmaf(u.z, v1.z, acc[j][1]);
          acc[j][1] = fmaf(u.w, v1.w, acc[j][1]);
        }
      }
      __syncthreads();
    }

    // distances + validity -> shared distance tile (+inf = not a candidate)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg + 64 * h, row = t0 + r;
      const bool in = row < row_end;
      uint32_t aw[W];
      uint32_t at[P > 0 ? P : 1];
      float vn = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) aw[w] = in ? a.auth[(size_t)w * a.N + row] : 0u;
#pragma unroll
      for (int p = 0; p < P; ++p) at[p] = in ? a.attr[(size_t)p * a.N + row] : 0u;
      if (in) vn = a.dbn[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = qb + j;
        float dv = INFINITY;
        if (in && q0 + qi < a.B) {
          const float v = __fsub_rn(__fadd_rn(qn_s[qi], vn), __fmul_rn(2.f, acc[j][h]));
          bool ok = false;
#pragma unroll
          for (int w = 0; w < W; ++w) ok |= (aw[w] & role_s[qi * W + w]) != 0u;
          ok = ok && v < bnd_s[qi];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint32_t rq = req_s[qi * P + p];
            ok = ok && (at[p] & rq) == rq && (at[p] & forb_s[qi * P + p]) == 0u;
          }
          if (ok) dv = v;
        }
        dist[qi * TN + r] = dv;
      }
    }
    __syncthreads();

    // selection: one warp per query, candidates in ascending id order
    for (int qi = warp; qi < BQ; qi += WARPS) {
      if (q0 + qi >= a.B) continue;
      float* Ld = list_d + qi * k;
      int* Li = list_i + qi * k;
      float thr_d = Ld[k - 1];
      int thr_i = Li[k - 1];
#pragma unroll
      for (int u = 0; u < TN / 32; ++u) {
        const int r = lane + 32 * u;
        const float cd = dist[qi * TN + r];
        const int ci = t0 + r;
        unsigned m = __ballot_sync(FULL, cd < INFINITY && lex_less(cd, ci, thr_d, thr_i));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float xd = __shfl_sync(FULL, cd, src);
          const int xi = __shfl_sync(FULL, ci, src);
          if (!lex_less(xd, xi, thr_d, thr_i)) continue;
          warp_insert(Ld, Li, k, xd, xi, lane);
          thr_d = Ld[k - 1];
          thr_i = Li[k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int qi = warp; qi < BQ; qi += WARPS) {
    const int qg = q0 + qi;
    if (qg >= a.B) continue;
    const size_t base = ((size_t)qg * a.S + s) * k;
    for (int p = lane; p < k; p += 32) {
      const int id = list_i[qi * k + p];
      a.part_d[base + p] = list_d[qi * k + p];
      a.part_i[base + p] = id == ID_NONE ? -1 : id;
    }
  }
}

__device__ __forceinline__ void load_head(const float* pd, const int* pi,
                                          int j, int p, int k, float& hd,
                                          int& hi) {
  hd = pd[(size_t)j * k + p];
  hi = pi[(size_t)j * k + p];
  if (hi < 0) {
    hd = INFINITY;
    hi = ID_NONE;
  }
}

// One warp per query: k-way merge of the S sorted partial lists.  Lane l
// owns lists l, l + 32, ...; each round the warp takes the (dist, id)
// minimum of the list heads and its owner advances.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
l2_topk_merge(const Args a) {
  constexpr int MAXT = MAX_SPLITS / 32;
  const int lane = threadIdx.x & 31;
  const int qg = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (qg >= a.B) return;
  const int k = a.k, S = a.S;
  const float* pd = a.part_d + (size_t)qg * S * k;
  const int* pi = a.part_i + (size_t)qg * S * k;
  int ptr[MAXT];
  float hd[MAXT];
  int hi[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const int j = lane + 32 * t;
    ptr[t] = 0;
    hd[t] = INFINITY;
    hi[t] = ID_NONE;
    if (j < S) load_head(pd, pi, j, 0, k, hd[t], hi[t]);
  }
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bi = ID_NONE, bt = -1;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (lex_less(hd[t], hi[t], bd, bi)) {
        bd = hd[t];
        bi = hi[t];
        bt = t;
      }
    }
    float wd = bd;
    int wi = bi;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, wd, off);
      const int oi = __shfl_xor_sync(FULL, wi, off);
      if (lex_less(od, oi, wd, wi)) {
        wd = od;
        wi = oi;
      }
    }
    if (lane == 0) {
      a.out_d[(size_t)qg * k + r] = wi == ID_NONE ? INFINITY : wd;
      a.out_i[(size_t)qg * k + r] = wi == ID_NONE ? -1 : wi;
    }
    if (wi != ID_NONE && bi == wi) {
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t == bt) {
          ++ptr[t];
          if (ptr[t] < k) {
            load_head(pd, pi, lane + 32 * t, ptr[t], k, hd[t], hi[t]);
          } else {
            hd[t] = INFINITY;
            hi[t] = ID_NONE;
          }
        }
      }
    }
  }
}

template <int W, int P>
cudaError_t launch_partial(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l2_topk_partial<W, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.B + BQ - 1) / BQ, a.S);
  l2_topk_partial<W, P><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Args&, size_t, cudaStream_t);

#define L2_TOPK_ROW(W)                                                     \
  {launch_partial<W, 0>, launch_partial<W, 1>, launch_partial<W, 2>,       \
   launch_partial<W, 3>, launch_partial<W, 4>}

const LaunchFn kPartial[MAX_W][MAX_P + 1] = {
    L2_TOPK_ROW(1), L2_TOPK_ROW(2), L2_TOPK_ROW(3), L2_TOPK_ROW(4),
    L2_TOPK_ROW(5), L2_TOPK_ROW(6), L2_TOPK_ROW(7), L2_TOPK_ROW(8)};

}  // namespace

// Launches the partial scan and the merge on `stream`; returns the
// cudaError_t of the launches (0 on success).  Does not synchronise.
extern "C" int l2_topk_launch(const float* q, const float* db,
                              const float* dbn, const uint32_t* auth,
                              const uint32_t* role, const float* bound,
                              const uint32_t* attr, const uint32_t* req,
                              const uint32_t* forb, int B, int N, int d,
                              int k, int W, int P, int S, int chunk,
                              float* part_d, int* part_i, float* out_d,
                              int* out_i, void* stream) {
  if (B < 1 || N < 1 || d < 1 || k < 1 || k > KMAX || W < 1 || W > MAX_W ||
      P < 0 || P > MAX_P || S < 1 || S > MAX_SPLITS || chunk < 1 ||
      (long long)S * chunk < N || (P > 0 && (!attr || !req || !forb)))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.db = db;
  a.dbn = dbn;
  a.auth = auth;
  a.role = role;
  a.bound = bound;
  a.attr = attr;
  a.req = req;
  a.forb = forb;
  a.B = B;
  a.N = N;
  a.d = d;
  a.dpad = (d + DK - 1) / DK * DK;
  a.k = k;
  a.S = S;
  a.chunk = chunk;
  a.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0;
  a.part_d = part_d;
  a.part_i = part_i;
  a.out_d = out_d;
  a.out_i = out_i;
  const size_t smem = sizeof(float) * ((size_t)BQ * a.dpad + TN * DKS + BQ * TN) +
                      (sizeof(float) + sizeof(int)) * (size_t)BQ * k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = kPartial[W - 1][P](a, smem, st);
  if (e != cudaSuccess) return e;
  const int blocks = (B + MERGE_WARPS - 1) / MERGE_WARPS;
  l2_topk_merge<<<blocks, MERGE_WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" const char* l2_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

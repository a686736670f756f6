// Forward attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _flash_kernel (launched by flash_attention_pallas).  Same function, with
// the causal diagonal and the kv length as runtime arguments:
//   s = (q . k) * scale over the head dim, scale = hd^-0.5 (true hd);
//   column n is valid for query position i iff n < kv_len and, when causal,
//   n <= i + q_offset;
//   out = sum_n p_n v_n / max(sum_n p_n, 1e-30), p = exp(s - running max),
//   so a row with no valid column gives 0, never NaN.
// q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), each with its own
// batch / position / head strides (the last dim contiguous), bf16 or f32;
// the math is f32 and out is (B, Sq, Hq, hd) f32, contiguous.  Query head h
// reads kv head h / (Hq / Hkv): grouped-query attention by index, with no
// repeated copy of k or v.
//
// What bounds it on an H100: a prefill of S tokens does 4 * S^2/2 * hd
// operations per head against about 3 * S * hd inputs, far above the card's
// float32 ridge (67 TFLOP/s over 3.35 TB/s, about 20 per byte): FMA
// throughput bounds it.  A decode step (Sq = 1) does 4 * kv_len * hd per
// head against the whole cache: HBM bandwidth bounds it.
//
// What the design does about that (a simple, correct first version):
//   * One CTA per (tile of BM query rows, kv head, batch).  A row is a
//     (query position, query head of this kv head) pair, so the Hq / Hkv
//     query heads that share a kv head share its k / v tiles: in decode the
//     rep heads of one position fill rep rows of the tile.
//   * The Pallas grid walks the kv tiles in order and carries m, l and acc
//     in scratch; here the CTA loops over kv tiles itself and keeps m, l and
//     acc in registers.  The loop stops at the last tile any of its rows may
//     see (kv_len, and the causal diagonal), so a causal prefill does about
//     half the tiles.
//   * k and v tiles are staged in shared memory as f32; a thread owns 4 rows
//     x 8 columns of the score tile and 4 rows x hd/8 columns of the output,
//     reading rows at a padded stride so shared-memory reads do not conflict;
//     row max and row sum reduce over the 8 lanes of a row with shuffles.
//   * Every product is a float32 FMA (no tensor cores, no TF32), so the
//     result matches a float32 reference.  wgmma, TMA and split-KV for long
//     decodes are for later versions.
//   * No padding copies: ragged query rows, kv positions and head dims are
//     masked in-kernel; the head dim is padded to HDP (32, 64 or 128) in
//     shared memory only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // query rows per CTA
constexpr int BN = 64;            // kv positions per tile
constexpr int THREADS = 128;
constexpr int TX = 8;             // threads sharing one row
constexpr int TY = THREADS / TX;  // 16 row groups
constexpr int RPT = BM / TY;      // rows per thread: 4
constexpr int CPT = BN / TX;      // score columns per thread: 8
constexpr int PS = BN + 1;        // shared row stride of the P tile
constexpr int MAX_HD = 128;
constexpr unsigned FULL = 0xffffffffu;

static_assert(TX == 8, "row reductions shuffle over 8 neighbouring lanes");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  int Sq, Hq, rep, hd;
  long long qb, qs, qh;  // element strides of q: batch, position, head
  long long kb, ks, kh;
  long long vb, vs, vh;
  int causal, q_offset, kv_len;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BM * (HDP + 1) + (size_t)BN * (HDP + 1) +
          (size_t)BN * HDP + (size_t)BM * PS);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_fwd(const Args a) {
  constexpr int QS = HDP + 1;     // shared row stride of Q and K
  constexpr int OPT = HDP / TX;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // BM x QS
  float* sK = sQ + BM * QS;       // BN x QS
  float* sV = sK + BN * QS;       // BN x HDP
  float* sP = sV + BN * HDP;      // BM x PS

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int g = blockIdx.y;       // kv head
  const int b = blockIdx.z;
  const int rows = a.Sq * a.rep;
  const T* q = static_cast<const T*>(a.q) + b * a.qb;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + g * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + g * a.vh;

  for (int e = tid; e < BM * HDP; e += THREADS) {
    const int r = e / HDP;
    const int d = e % HDP;
    const int m = m0 + r;
    float x = 0.f;
    if (m < rows && d < a.hd) {
      const int i = m / a.rep;
      const int h = g * a.rep + m % a.rep;
      x = to_f32(q[i * a.qs + h * a.qh + d]);
    }
    sQ[r * QS + d] = x;
  }

  int pos[RPT];
  bool live[RPT];
  float mrun[RPT], lrun[RPT], acc[RPT][OPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + ty + TY * r;
    live[r] = m < rows;
    pos[r] = m / a.rep + a.q_offset;   // last column the row may see
    mrun[r] = -INFINITY;
    lrun[r] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[r][j] = 0.f;
  }

  // Last column any row of this tile may see, plus one.
  int kv_end = a.kv_len;
  if (a.causal) {
    const int last_row = min(rows, m0 + BM) - 1;
    kv_end = min(kv_end, last_row / a.rep + a.q_offset + 1);
  }

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();              // the previous tile's reads are done
    for (int e = tid; e < BN * HDP; e += THREADS) {
      const int c = e / HDP;
      const int d = e % HDP;
      const int n = n0 + c;
      float kx = 0.f, vx = 0.f;
      if (n < a.kv_len && d < a.hd) {
        kx = to_f32(kp[n * a.ks + d]);
        vx = to_f32(vp[n * a.vs + d]);
      }
      sK[c * QS + d] = kx;
      sV[c * HDP + d] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = sQ[(ty + TY * r) * QS + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[(tx + TX * c) * QS + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int n = n0 + tx + TX * c;
        const bool ok = live[r] && n < a.kv_len && (!a.causal || n <= pos[r]);
        s[r][c] = ok ? s[r][c] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float mnew = fmaxf(mrun[r], row_max(mx));
      const float safe = mnew == -INFINITY ? 0.f : mnew;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - safe);
        sP[(ty + TY * r) * PS + tx + TX * c] = p;
        sum += p;
      }
      const float alpha = mrun[r] == -INFINITY ? 0.f : expf(mrun[r] - safe);
      lrun[r] = lrun[r] * alpha + row_sum(sum);
      mrun[r] = mnew;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = sP[(ty + TY * r) * PS + n];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = sV[n * HDP + tx + TX * j];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!live[r]) continue;
    const int m = m0 + ty + TY * r;
    const int i = m / a.rep;
    const int h = g * a.rep + m % a.rep;
    float* o = a.out + (((long long)b * a.Sq + i) * a.Hq + h) * a.hd;
    const float l = fmaxf(lrun[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int d = tx + TX * j;
      if (d < a.hd) o[d] = acc[r][j] / l;
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_fwd<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq * a.rep + BM - 1) / BM, Hkv, B);
  flash_attention_fwd<T, HDP><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (a.hd <= 32) return launch<T, 32>(a, B, Hkv, stream);
  if (a.hd <= 64) return launch<T, 64>(a, B, Hkv, stream);
  return launch<T, 128>(a, B, Hkv, stream);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  `bf16` selects bf16 inputs, else float32.  Does not
// synchronise.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, float* out, int bf16, int B,
    int Sq, int Sk, int Hq, int Hkv, int hd, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, int causal, int q_offset, int kv_len,
    float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq < Hkv || Hq % Hkv != 0 || hd < 1 || hd > MAX_HD || kv_len < 0 ||
      kv_len > Sk || (long long)Sq * (Hq / Hkv) > 0x7fffffffLL - BM)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Sq = Sq;
  a.Hq = Hq;
  a.rep = Hq / Hkv;
  a.hd = hd;
  a.qb = qb;
  a.qs = qs;
  a.qh = qh;
  a.kb = kb;
  a.ks = ks;
  a.kh = kh;
  a.vb = vb;
  a.vs = vs;
  a.vh = vh;
  a.causal = causal;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(a, B, Hkv, st)
              : launch_hd<float>(a, B, Hkv, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

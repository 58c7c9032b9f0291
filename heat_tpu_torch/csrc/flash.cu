// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces heat_tpu/ops/flash.py::_attn_kernel (the Pallas TPU kernel that
// heat_tpu.nn.flash_attention(impl="pallas") reaches). From q [B, S, H, D]
// and k, v [B, SK, H, D], all f32 or all bf16, with D <= 512, it computes
// per (b, h) and query row i
//
//     s[j]   = (scale * q_i) . k_j          (scale folded into q first)
//     s[j]   = -1e30 where j >= SK, or where causal and i < j
//     o_i    = sum_j exp(s[j] - m) v_j / sum_j exp(s[j] - m),   m = max_j s[j]
//
// as an online softmax over tiles of keys, with the state (m, l, acc) in
// f32 and the numerics of the TPU kernel:
//
//  * q is scaled in f32, then rounded to bf16 for bf16 inputs;
//  * for bf16, both products take bf16 operands (held as f32 in shared
//    memory: a product of two bf16 values is exact in f32) and sum in f32,
//    and p is rounded to bf16 before p.V while l adds the unrounded p;
//  * masked scores are the finite -1e30, p is zeroed while the running max
//    is <= -1e30/2, and the division uses l only where l > 0, so a row with
//    no live key comes out as 0, not NaN;
//  * causal: the tile loop of a query tile stops at the tile whose first
//    key lies past the query tile's last row, so those K/V tiles are
//    neither loaded nor computed.
//
// What bounds it: operations. A launch does 4*B*H*S*SK*D flops (half of
// that when causal) against (|q| + |k| + |v| + |o|) bytes; at the main
// path's shape (4, 4096, 12, 64) causal f32 that is 103 GFLOP against
// 50 MB, far above the card's ratio of flops to bytes. In f32 the products
// run on the CUDA cores (a tensor-core product would round f32 to TF32), so
// the design keeps each thread's arithmetic in registers and reads shared
// memory with 16-byte loads:
//
//  * One CTA of 256 threads owns BQ query rows of one (b, h); it walks the
//    keys in tiles of BK rows. The Q tile stays in shared memory; each K/V
//    tile is loaded once per CTA straight from [B, S, H, D] (row stride
//    given by the caller; no padded or transposed copy), the tails of S and
//    SK and the columns past D filled with 0.
//  * The threads form a 16 x 16 grid: thread (ty, tx) owns query rows
//    ty*TM .. ty*TM+TM-1, the score columns tx + 16*j and the output columns
//    tx*4 + 64*j .. +3, so each row's max and sum are reduced across 16 lanes
//    of one warp with shuffles, and the row state (m, l) and the row's
//    output accumulator live in the same thread.
//  * Shared memory rows of Q and K have a stride of an odd number of 16-byte
//    groups, so the 16-byte loads of one quarter-warp hit distinct banks.
//  * BQ and BK shrink as D grows (64x64 up to D=64, 64x32 up to 128, 32x32 up
//    to 256, 16x32 up to 512), so Q, K, V and P fit in the 227 KB a block may
//    use and each thread keeps at most 32 accumulators.
//  * One CTA writes each output row and there are no atomics, so a result
//    repeats bit for bit. CTAs are issued from the last query tile to the
//    first, the longest causal rows first.
//
// The C interface takes raw pointers, strides in elements and a stream, and
// returns the CUDA error code of the launch; heat_tpu_torch/ops/flash.py binds
// it with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, S, SK, D;
  long long qsb, qss, qsh;  // strides in elements of b, s and h; d is contiguous
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// max and sum over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats, for head dim D: Q (BQ x QS), K (BK x QS),
// V (BK x D8) and P (BQ x (BK + 4)), with D8 = D rounded up to 8 and
// QS = D8 + 4.
template <int BQ, int BK>
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)(BQ + BK) * (((D + 7) & ~7) + 4) + (size_t)BK * ((D + 7) & ~7) +
         (size_t)BQ * (BK + 4);
}

template <int BQ, int BK, int DPAD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p, int nq) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int TM = BQ / 16;    // query rows per thread
  constexpr int TN = BK / 16;    // score columns per thread
  constexpr int NJ = DPAD / 64;  // groups of 4 output columns per thread
  constexpr int PS = BK + 4;     // row stride of P
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && BK % 4 == 0 && DPAD % 64 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int D8 = (D + 7) & ~7;
  const int QS = D8 + 4;  // (D8 + 4) / 4 is odd: 16-byte loads of 8 rows hit distinct banks
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * D8;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int BH = p.B * p.H;
  const int iq = nq - 1 - (int)(blockIdx.x / BH);  // the longest causal rows first
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = iq * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;

  // the Q tile, scaled in f32 (and rounded to bf16 for bf16 inputs)
  for (int e = tid; e < BQ * D8; e += kThreads) {
    const int r = e / D8;
    const int d = e - r * D8;
    float x = 0.f;
    if (q0 + r < p.S && d < D) {
      x = to_f32(qg[(long long)(q0 + r) * p.qss + d]) * p.scale;
      if (kBf16) x = round_bf16(x);
    }
    Qs[r * QS + d] = x;
  }

  float m[TM], l[TM], acc[TM][NJ][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jd][c] = 0.f;
  }

  // causal: keys past the tile's last row are dead, and so is every tile
  // that starts past it
  const int k_end = p.causal ? min(p.SK, q0 + BQ) : p.SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's P.V is done with Ks, Vs and Ps
    for (int e = tid; e < BK * D8; e += kThreads) {
      const int r = e / D8;
      const int d = e - r * D8;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.SK && d < D) {
        kx = to_f32(kg[(long long)(k0 + r) * p.kss + d]);
        vx = to_f32(vg[(long long)(k0 + r) * p.vss + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * D8 + d] = vx;
    }
    __syncthreads();

    // scores s = (scale q) . k for this thread's TM x TN block
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D8; d += 4) {
      float4 a[TM], kb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(&Qs[(ty * TM + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < TN; ++j) kb[j] = ld4(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, kb[j].x, t);
          t = fmaf(a[i].y, kb[j].y, t);
          t = fmaf(a[i].z, kb[j].z, t);
          t = fmaf(a[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

    // online softmax: mask, fold the tile into (m, l), rescale acc, P to smem
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty * TM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < p.SK && (!p.causal || qi >= kj);
        s[i][j] = keep ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const bool live = m_new > kNegInf / 2;  // else every key so far is masked
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float e = live ? expf(s[i][j] - m_new) : 0.f;
        rs += e;
        Ps[(ty * TM + i) * PS + tx + 16 * j] = kBf16 ? round_bf16(e) : e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jd][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V over this tile's BK keys
    for (int c = 0; c < BK; c += 4) {
      float4 pr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pr[i] = ld4(&Ps[(ty * TM + i) * PS + c]);
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        const int col = tx * 4 + 64 * jd;
        if (col < D) {
          const float4 v0 = ld4(&Vs[(c + 0) * D8 + col]);
          const float4 v1 = ld4(&Vs[(c + 1) * D8 + col]);
          const float4 v2 = ld4(&Vs[(c + 2) * D8 + col]);
          const float4 v3 = ld4(&Vs[(c + 3) * D8 + col]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            float* a = acc[i][jd];
            a[0] = fmaf(pr[i].x, v0.x, a[0]);
            a[1] = fmaf(pr[i].x, v0.y, a[1]);
            a[2] = fmaf(pr[i].x, v0.z, a[2]);
            a[3] = fmaf(pr[i].x, v0.w, a[3]);
            a[0] = fmaf(pr[i].y, v1.x, a[0]);
            a[1] = fmaf(pr[i].y, v1.y, a[1]);
            a[2] = fmaf(pr[i].y, v1.z, a[2]);
            a[3] = fmaf(pr[i].y, v1.w, a[3]);
            a[0] = fmaf(pr[i].z, v2.x, a[0]);
            a[1] = fmaf(pr[i].z, v2.y, a[1]);
            a[2] = fmaf(pr[i].z, v2.z, a[2]);
            a[3] = fmaf(pr[i].z, v2.w, a[3]);
            a[0] = fmaf(pr[i].w, v3.x, a[0]);
            a[1] = fmaf(pr[i].w, v3.y, a[1]);
            a[2] = fmaf(pr[i].w, v3.z, a[2]);
            a[3] = fmaf(pr[i].w, v3.w, a[3]);
          }
        }
      }
    }
  }

  // o = acc / l, where l > 0; the output is [B, S, H, D], contiguous
  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty * TM + i;
    if (qi >= p.S) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* row = og + (((long long)b * p.S + qi) * p.H + h) * D;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int col = tx * 4 + 64 * jd;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < D) row[col + c] = from_f32<T>(acc[i][jd][c] / denom);
    }
  }
}

template <int BQ, int BK, int DPAD, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<BQ, BK, DPAD, T>;
  const size_t smem = smem_floats<BQ, BK>(p.D) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + BQ - 1) / BQ;
  const long long grid = (long long)nq * p.B * p.H;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p, nq);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64, 64, 64, T>(p, stream);
  if (p.D <= 128) return launch<64, 32, 128, T>(p, stream);
  if (p.D <= 256) return launch<32, 32, 256, T>(p, stream);
  return launch<16, 32, 512, T>(p, stream);
}

}  // namespace

extern "C" {

// One launch over all of B*H. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                    int SK, int D, long long qsb, long long qss, long long qsh, long long ksb,
                    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                    float scale, int causal, int bf16, void* stream) {
  if (B < 0 || H < 0 || S < 0 || SK < 0 || D < 1 || D > 512) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, H, S, SK, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                 scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s));
}

}  // extern "C"

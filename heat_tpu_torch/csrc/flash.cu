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
//  * for bf16, both products take bf16 operands and sum in f32, and p is
//    rounded to bf16 before p.V while l adds the unrounded p;
//  * masked scores are the finite -1e30, p is zeroed while the running max
//    is <= -1e30/2, and the division uses l only where l > 0, so a row with
//    no live key comes out as 0, not NaN;
//  * causal: the tile loop of a query tile stops at the tile whose first
//    key lies past the query tile's last row, so those K/V tiles are
//    neither loaded nor computed;
//  * one CTA writes each output row and there are no atomics, so a result
//    repeats bit for bit; CTAs are issued from the last query tile to the
//    first, the longest causal rows first.
//
// What bounds it: operations. A launch does 4*B*H*S*SK*D flops (about half
// of that when causal) against (|q| + |k| + |v| + |o|) bytes; at the main
// path's shape (4, 4096, 12, 64) causal f32 that is 103 GFLOP against
// 50 MB, far above the card's ratio of flops to bytes. Two designs, chosen
// by D alone (dispatch below):
//
// D <= 128: the tensor cores, a CTA of one warpgroup (4 warps, 64 query
// rows of one (b, h), 16 per warp).
//  * f32 (flash_fwd_kernel_wgmma) runs each product as three TF32
//    products: x = big + small with big = x rounded to 10 mantissa bits (to
//    nearest, ties away from zero, as cvt.rna.tf32.f32) and small = x - big
//    rounded the same way, and a.b = a_small.b_big + a_big.b_small +
//    a_big.b_big, summed in f32; the small.small term (2^-22 relative) is
//    dropped. The error stays near f32's (about 2^-21 relative per
//    product), where one TF32 product would round each operand to 2^-11.
//    The bound is 3 x flops at the 495 TFLOP/s dense TF32 rate, which only
//    wgmma approaches; mma.sync runs TF32 well below it on this card.
//    Q.K^T is wgmma m64n32k8 with Q and K from shared memory; P.V is
//    m64n{64,128}k8 with P from registers. tf32 wgmma takes K-major
//    operands only, so K lies as [key][d] and V transposed as [d][key],
//    both in core matrices of 8 rows x 16 bytes without swizzle.
//  * f32 tiles of 32 keys: cp.async copies the raw K/V rows (16 bytes per
//    copy) into one raw buffer while the previous tile computes; each
//    thread then splits the chunks it copied itself into the next of two
//    stages (K big/small, V^T big/small), so there is no second barrier,
//    and it does so while that previous tile's P.V runs on the tensor
//    cores. One __syncthreads per tile. Q is scaled and split once per CTA
//    into shared memory.
//  * bf16 (flash_fwd_kernel_mma) runs mma.sync m16n8k16 on bf16 operands,
//    as the TPU kernel does: K/V tiles of 64 keys in two cp.async stages,
//    read with ldmatrix (.trans for V), Q in registers.
//  * The scores and the output accumulator live in the accumulator
//    fragments (the same layout for wgmma and mma.sync: each thread holds
//    rows g and g + 8 of its warp's 16). The online softmax runs on them;
//    a row's max and sum reduce across the 4 lanes of its group.
//  * P stays in registers for P.V. In bf16 the m16n8k16 accumulator layout
//    of two adjacent key groups of 8 is the A layout of one k-step of 16.
//    In TF32 the accumulator holds keys (2t, 2t+1) of a group of 8 where
//    the A fragment wants keys (t, t+4); the design permutes the keys of
//    each group instead of the values (A's column t holds key 2t, column
//    t+4 key 2t+1) and lays V^T out with the same permutation.
//  * Every shared-memory offset is a compile-time constant: the layout is
//    fixed per DMAX (64 or 128), and D == DMAX has its own instantiation
//    without the guards of a ragged D. Where a base pointer or a row
//    stride is not a multiple of 16 bytes, the same 16-byte chunks are
//    copied element by element. Columns past D and rows past SK are
//    zero-filled.
//
// 128 < D <= 512: the CUDA cores (flash_fwd_kernel), in f32 FMA: one CTA
// of 256 threads per (query tile, b, h) as a 16 x 16 thread grid, with Q,
// K, V and P in shared memory and 16-byte shared loads; tiles shrink with
// D (32 x 32 up to 256, 16 x 32 up to 512) to fit the 227 KB of a block.
//
// The C interface takes raw pointers, strides in elements and a stream, and
// returns the CUDA error code of the launch; heat_tpu_torch/ops/flash.py binds
// it with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

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
  int vec;  // 16-byte copies: every base pointer and row stride is 16-byte aligned
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

// ---------------------------------------------------------------------------
// D <= 128: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows per CTA: one warpgroup of 64 rows
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small, both TF32; x - big is exact in f32. big is rounded with
// two integer operations (half of the 13 dropped bits added, then dropped):
// cvt.rna's result for every finite x and for infinities; a NaN whose
// rounding would wrap still reaches the products through small, which
// cvt.rna rounds.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  uint32_t b[4], s[4];
  split(x.x, b[0], s[0]);
  split(x.y, b[1], s[1]);
  split(x.z, b[2], s[2]);
  split(x.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                    __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                      __uint_as_float(s[3]));
}
// two f32 as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8 x 8 b16 matrices from shared memory, one row address per lane
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Warpgroup MMA, m64nNk8 with TF32 operands and f32 accumulators in the
// m16n8 accumulator layout of each warp (d[4j + i] is column group j). B
// comes from shared memory, K-major; A from shared memory through a
// descriptor (wgmma_ss: Q.K^T, n = 32 keys) or from registers as each
// warp's m16n8k8 A fragment (wgmma_rs: P.V, n = D of 64 or 128).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared writes of this thread visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A K-major wgmma operand of COLS columns (the K dimension) in shared
// memory, without swizzle: core matrices of 8 rows x 4 columns (16 bytes a
// row, 128 bytes each); along K they are 128 bytes apart (the descriptor's
// leading byte offset), along the rows COLS * 32 bytes (its stride offset).
template <int COLS>
__device__ __forceinline__ int core_offset(int row, int col) {
  return (row >> 3) * (COLS * 8) + (col >> 2) * 32 + (row & 7) * 4 + (col & 3);
}
template <int COLS>
__device__ __forceinline__ uint64_t core_desc(const float* base) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(base));
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)((COLS * 32) >> 4) << 32);
}
// the descriptor of the k-step of 8 columns that starts at column 8 * ks
__device__ __forceinline__ uint64_t desc_step(uint64_t d, int ks) { return d + 16 * ks; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Chunk e (16 bytes) of a ROWS x (PER_ROW chunks) tile: each 32 consecutive
// chunks cover 8 rows x 4 chunk columns, so a warp reads 64 contiguous
// bytes of 8 rows and its 16-byte shared stores of one column hit 8
// distinct 16-byte bank groups.
template <int ROWS, int PER_ROW>
__device__ __forceinline__ void chunk_of(int e, int& r, int& cq) {
  static_assert(ROWS % 8 == 0 && PER_ROW % 4 == 0, "whole blocks of 8 x 4 chunks");
  const int b = e >> 5;
  r = (b % (ROWS / 8)) * 8 + (e & 7);
  cq = (b / (ROWS / 8)) * 4 + ((e & 31) >> 3);
}

// Rows [row0, row0 + ROWS) of a [*, D] operand (row stride rs, rows past
// nvalid and columns past D read as zero) into shared rows of LDS elements,
// columns [0, DMAX), in 16-byte chunks; chunk e belongs to thread
// e % kMmaThreads. A chunk is one cp.async where vec, else it is read
// element by element and stored as one 16-byte word.
template <typename T, int ROWS, int DMAX, int LDS>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long rs, int row0, int nvalid,
                                          int D, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = DMAX / V;
  static_assert(ROWS * PER_ROW % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / kMmaThreads; ++i) {
    int r, cq;
    chunk_of<ROWS, PER_ROW>(threadIdx.x + i * kMmaThreads, r, cq);
    const int c = cq * V;
    const int n = row0 + r < nvalid ? max(0, min(V, D - c)) : 0;
    const T* s = src + (long long)(row0 + r) * rs + c;
    T* d = dst + r * LDS + c;
    if (vec) {
      cp_async16(d, n ? s : src, n * (int)sizeof(T));
    } else {
      alignas(16) T x[V];
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = j < n ? s[j] : from_f32<T>(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

// the masked score: the ragged end of the keys and, causal, the keys past
// each row (rows g and g + 8 of the warp that starts at query row qw)
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[4 * NT], const Params& p, int k0, int qw,
                                            int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 8 * nt + 2 * t + (i & 1);
      const int qi = qw + g + 8 * (i >> 1);
      if (kj >= p.SK || (p.causal && qi < kj)) s[4 * nt + i] = kNegInf;
    }
}

// The online softmax on accumulator fragments: rows g (r = 0) and g + 8
// (r = 1) of the warp; a row's max and sum reduce across the 4 lanes of its
// group. s becomes p; returns the rescale of the old state in alpha.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[4 * NT], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const bool live = mx > kNegInf / 2;  // else every key so far is masked
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * nt + 2 * r + c];
        x = live ? __expf(x - mx) : 0.f;
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    alpha[r] = __expf(m[r] - mx);
    l[r] = alpha[r] * l[r] + rs;
    m[r] = mx;
  }
}
template <int ND>
__device__ __forceinline__ void rescale(float (&o)[4 * ND], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// o / l where l > 0 into the output, [B, S, H, D] contiguous
template <typename T, int ND>
__device__ __forceinline__ void store_rows(const Params& p, const float (&o)[4 * ND],
                                           const float (&l)[2], int b, int h, int qw, int D,
                                           int nd, int g, int t) {
  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    if (qi >= p.S) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    T* row = og + (((long long)b * p.S + qi) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + 2 * t;
      if (j < nd && col < D) {
        const float x0 = o[4 * j + 2 * r] / denom;
        const float x1 = o[4 * j + 2 * r + 1] / denom;
        if ((D & 1) == 0) {  // col + 1 < D and the pair is aligned
          if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
          }
        } else {
          row[col] = from_f32<T>(x0);
          if (col + 1 < D) row[col + 1] = from_f32<T>(x1);
        }
      }
    }
  }
}

// where a CTA starts: its query tile (the longest causal rows first), its
// (b, h), and the number of K/V tiles of BK keys it visits
struct Tile {
  int b, h, q0, ntiles;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int nq, int bk) {
  const int BH = p.B * p.H;
  const int iq = nq - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  Tile w;
  w.b = bh / p.H;
  w.h = bh - w.b * p.H;
  w.q0 = iq * kBQ;
  // causal: keys past the tile's last row are dead, and so is every tile
  // that starts past it
  const int k_end = p.causal ? min(p.SK, w.q0 + kBQ) : p.SK;
  w.ntiles = (k_end + bk - 1) / bk;
  return w;
}

// f32: 3 x TF32 on wgmma. Shared memory (floats): the raw K/V tile
// [2 * BK][DMAX] that cp.async fills; two stages of split K (big, small;
// [BK][DMAX] core matrices) and split V^T (big, small; [DMAX][BK], keys
// permuted within each group of 8 as P's A fragment holds them); the split
// Q of the CTA (big, small; [64][DMAX]).
template <int DMAX>
struct WgmmaShape {
  static constexpr int BK = 32;                   // keys per tile (n of Q.K^T)
  static constexpr int PLANE = BK * DMAX;         // one split half of K or of V^T
  static constexpr int STAGE = 4 * PLANE;         // K big, K small, V^T big, V^T small
  static constexpr int RAW = 2 * PLANE;           // K then V, rows of DMAX
  static constexpr int QPLANE = kBQ * DMAX;
  static constexpr size_t smem_bytes() {
    return (size_t)(RAW + 2 * STAGE + 2 * QPLANE) * sizeof(float);
  }
};

// the K/V chunks this thread copied into raw, split into a stage
template <int DMAX>
__device__ __forceinline__ void split_kv(float* stage, const float* raw) {
  using W = WgmmaShape<DMAX>;
  constexpr int BK = W::BK;
  constexpr int PER_ROW = DMAX / 4;
  constexpr int K_CHUNKS = BK * PER_ROW;
  float* kb = stage;
  float* ks = kb + W::PLANE;
  float* vb = ks + W::PLANE;
  float* vs = vb + W::PLANE;
#pragma unroll
  for (int i = 0; i < 2 * K_CHUNKS / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const bool is_v = e >= K_CHUNKS;  // the same for all threads of one i
    int r, cq;
    chunk_of<BK, PER_ROW>(e - (is_v ? K_CHUNKS : 0), r, cq);
    const int c = 4 * cq;
    float4 big, small;
    split4(*reinterpret_cast<const float4*>(raw + ((is_v ? BK : 0) + r) * DMAX + c), big, small);
    if (!is_v) {
      const int off = core_offset<DMAX>(r, c);
      *reinterpret_cast<float4*>(kb + off) = big;
      *reinterpret_cast<float4*>(ks + off) = small;
    } else {
      // V^T: row d, column kk = the key's place in P's A fragment: column t
      // holds key 2t and column t + 4 key 2t + 1 of each group of 8
      const int kk = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
      const float bv[4] = {big.x, big.y, big.z, big.w};
      const float sv[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = core_offset<BK>(c + j, kk);
        vb[off] = bv[j];
        vs[off] = sv[j];
      }
    }
  }
}

template <int DMAX, bool FULL, int MINB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
flash_fwd_kernel_wgmma(const Params p, int nq) {
  using W = WgmmaShape<DMAX>;
  constexpr int BK = W::BK;
  constexpr int NT = BK / 8;    // key groups of 8 (column groups of S)
  constexpr int ND = DMAX / 8;  // column groups of O
  constexpr int KQ = DMAX / 8;  // k-steps of Q.K^T
  constexpr int PER_ROW = DMAX / 4;
  static_assert(W::STAGE >= kBQ * DMAX, "the raw Q tile is staged in stage 1");

  extern __shared__ __align__(128) float smem_f32[];
  float* raw = smem_f32;
  float* stages = raw + W::RAW;
  float* qb = stages + 2 * W::STAGE;
  float* qs = qb + W::QPLANE;

  const int D = FULL ? DMAX : p.D;
  const int nkq = FULL ? KQ : (D + 7) >> 3;  // live k-steps
  const int nd = FULL ? ND : (D + 7) >> 3;   // live column groups
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group: rows g and g + 8 of the warp's 16
  const int t = lane & 3;   // lane within the group
  const Tile w = tile_of(p, nq, BK);
  const int qw = w.q0 + 16 * (threadIdx.x >> 5);  // the warp's first query row
  const bool vec = p.vec != 0;
  const float* qg = static_cast<const float*>(p.q) + w.b * p.qsb + w.h * p.qsh;
  const float* kg = static_cast<const float*>(p.k) + w.b * p.ksb + w.h * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + w.b * p.vsb + w.h * p.vsh;
  auto copy_tile = [&](int it) {
    copy_rows<float, BK, DMAX, DMAX>(raw, kg, p.kss, it * BK, p.SK, D, vec);
    copy_rows<float, BK, DMAX, DMAX>(raw + BK * DMAX, vg, p.vss, it * BK, p.SK, D, vec);
  };

  // prologue: Q raw into stage 1 and K/V tile 0 into raw; each thread then
  // scales and splits the Q chunks it copied and splits tile 0 into stage 0
  float* qraw = stages + W::STAGE;
  copy_rows<float, kBQ, DMAX, DMAX>(qraw, qg, p.qss, w.q0, p.S, D, vec);
  if (w.ntiles > 0) copy_tile(0);
  cp_async_commit();
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < kBQ * PER_ROW / kMmaThreads; ++i) {
    int r, cq;
    chunk_of<kBQ, PER_ROW>(threadIdx.x + i * kMmaThreads, r, cq);
    float4 x = *reinterpret_cast<const float4*>(qraw + r * DMAX + 4 * cq);
    x.x *= p.scale, x.y *= p.scale, x.z *= p.scale, x.w *= p.scale;
    float4 big, small;
    split4(x, big, small);
    const int off = core_offset<DMAX>(r, 4 * cq);
    *reinterpret_cast<float4*>(qb + off) = big;
    *reinterpret_cast<float4*>(qs + off) = small;
  }
  if (w.ntiles > 0) split_kv<DMAX>(stages, raw);
  fence_async_proxy();
  __syncthreads();

  const uint64_t dqb = core_desc<DMAX>(qb), dqs = core_desc<DMAX>(qs);
  float o[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < w.ntiles; ++it) {
    const int k0 = it * BK;
    const float* st = stages + (it & 1) * W::STAGE;
    const uint64_t dkb = core_desc<DMAX>(st), dks = core_desc<DMAX>(st + W::PLANE);
    const uint64_t dvb = core_desc<BK>(st + 2 * W::PLANE), dvs = core_desc<BK>(st + 3 * W::PLANE);

    // s = (scale q) . k: q_small.k_big + q_big.k_small + q_big.k_big
    float s[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      if (ks < nkq) {
        wgmma_ss(s, desc_step(dqs, ks), desc_step(dkb, ks));
        wgmma_ss(s, desc_step(dqb, ks), desc_step(dks, ks));
        wgmma_ss(s, desc_step(dqb, ks), desc_step(dkb, ks));
      }
    }
    wgmma_commit();
    if (it + 1 < w.ntiles) copy_tile(it + 1);  // loads while this tile computes
    cp_async_commit();
    wgmma_wait();
    fence_registers(s);

    if (k0 + BK > p.SK || (p.causal && k0 + BK - 1 > qw)) mask_scores<NT>(s, p, k0, qw, g, t);
    float alpha[2];
    online_softmax<NT>(s, m, l, alpha);
    rescale<ND>(o, alpha);

    // o += p . v from registers: A column t holds key 2t, column t + 4 key
    // 2t + 1 of each group of 8, as V^T lies in shared memory
    uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      split(s[4 * kt + 0], pb[kt][0], ps[kt][0]);
      split(s[4 * kt + 2], pb[kt][1], ps[kt][1]);
      split(s[4 * kt + 1], pb[kt][2], ps[kt][2]);
      split(s[4 * kt + 3], pb[kt][3], ps[kt][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      wgmma_rs(o, ps[kt], desc_step(dvb, kt));
      wgmma_rs(o, pb[kt], desc_step(dvs, kt));
      wgmma_rs(o, pb[kt], desc_step(dvb, kt));
    }
    wgmma_commit();
    if (it + 1 < w.ntiles) {  // the next stage, while p . v runs on this one
      cp_async_wait_all();
      split_kv<DMAX>(stages + ((it + 1) & 1) * W::STAGE, raw);
      fence_async_proxy();
    }
    wgmma_wait();
    fence_registers(o);
    __syncthreads();  // the next stage is complete; this one may be refilled
  }
  store_rows<float, ND>(p, o, l, w.b, w.h, qw, D, nd, g, t);
}

// bf16: mma.sync m16n8k16 on bf16 operands. Shared memory: two stages of
// K and V, [BK][DMAX + 8] bf16 each (16 bytes of padding, so the 8 rows an
// ldmatrix phase reads fall in distinct banks); Q is staged in stage 1.
template <int DMAX>
struct Bf16Shape {
  static constexpr int BK = 64;
  static constexpr int LDS = DMAX + 8;
  static constexpr int STAGE = 2 * BK * LDS;
  static constexpr size_t smem_bytes() { return (size_t)2 * STAGE * sizeof(__nv_bfloat16); }
};

template <int DMAX, bool FULL, int MINB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
flash_fwd_kernel_mma(const Params p, int nq) {
  using T = __nv_bfloat16;
  using Sh = Bf16Shape<DMAX>;
  constexpr int BK = Sh::BK;
  constexpr int LDS = Sh::LDS;
  constexpr int NT = BK / 8;    // key groups of 8 (column groups of S)
  constexpr int ND = DMAX / 8;  // column groups of O
  constexpr int KQ = DMAX / 16;  // k-steps of Q.K^T
  static_assert(Sh::STAGE >= kBQ * LDS, "the Q tile is staged in stage 1");

  extern __shared__ __align__(16) unsigned char smem_bf16[];
  T* stages = reinterpret_cast<T*>(smem_bf16);
  const int D = FULL ? DMAX : p.D;
  const int nkq = FULL ? KQ : (D + 15) >> 4;  // live k-steps
  const int nd = FULL ? ND : (D + 7) >> 3;    // live column groups
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;   // ldmatrix: the row of its 8 x 8 matrix this lane addresses
  const int lmat = lane >> 3;  // ldmatrix: which of the four matrices
  const Tile w = tile_of(p, nq, BK);
  const int qw = w.q0 + 16 * (threadIdx.x >> 5);
  const bool vec = p.vec != 0;
  const T* qg = static_cast<const T*>(p.q) + w.b * p.qsb + w.h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + w.b * p.ksb + w.h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + w.b * p.vsb + w.h * p.vsh;
  auto copy_tile = [&](int it) {
    T* dst = stages + (it & 1) * Sh::STAGE;
    copy_rows<T, BK, DMAX, LDS>(dst, kg, p.kss, it * BK, p.SK, D, vec);
    copy_rows<T, BK, DMAX, LDS>(dst + BK * LDS, vg, p.vss, it * BK, p.SK, D, vec);
  };

  // prologue: Q into stage 1, K/V tile 0 into stage 0
  copy_rows<T, kBQ, DMAX, LDS>(stages + Sh::STAGE, qg, p.qss, w.q0, p.S, D, vec);
  if (w.ntiles > 0) copy_tile(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the warp's Q fragments, scaled in f32, then rounded to bf16
  uint32_t qa[KQ][4];
  {
    const T* Q = stages + Sh::STAGE + (qw - w.q0) * LDS;
    auto at = [&](int r, int c) { return to_f32(Q[r * LDS + c]) * p.scale; };
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      if (ks < nkq) {
        const int c = 16 * ks + 2 * t;
        qa[ks][0] = pack_bf16(at(g, c), at(g, c + 1));
        qa[ks][1] = pack_bf16(at(g + 8, c), at(g + 8, c + 1));
        qa[ks][2] = pack_bf16(at(g, c + 8), at(g, c + 9));
        qa[ks][3] = pack_bf16(at(g + 8, c + 8), at(g + 8, c + 9));
      }
    }
  }
  __syncthreads();  // stage 1 is free for tile 1

  float o[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < w.ntiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < w.ntiles) copy_tile(it + 1);  // loads while this tile computes
    cp_async_commit();
    const T* st = stages + (it & 1) * Sh::STAGE;

    // s = (scale q) . k; B of column groups nt, nt + 1 for k-step ks from
    // matrices (nt, d 16ks), (nt, 16ks + 8), (nt + 1, 16ks), (nt + 1, 16ks + 8)
    float s[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
    const T* kl = st + (8 * (lmat >> 1) + lrow) * LDS + 8 * (lmat & 1);
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      if (ks < nkq) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kl + 8 * nt * LDS + 16 * ks);
          mma_bf16(s + 4 * nt, qa[ks], kb[0], kb[1]);
          mma_bf16(s + 4 * nt + 4, qa[ks], kb[2], kb[3]);
        }
      }
    }

    if (k0 + BK > p.SK || (p.causal && k0 + BK - 1 > qw)) mask_scores<NT>(s, p, k0, qw, g, t);
    float alpha[2];
    online_softmax<NT>(s, m, l, alpha);
    rescale<ND>(o, alpha);

    // o += p . v, p rounded to bf16 from the score fragments (the m16n8k16
    // accumulators of key groups 2kc and 2kc + 1 are the A fragment of
    // k-step kc); B of column groups j, j + 1 from matrices (keys 16kc, j),
    // (16kc + 8, j), (16kc, j + 1), (16kc + 8, j + 1), transposed
    const T* vl = st + BK * LDS + (8 * (lmat & 1) + lrow) * LDS + 8 * (lmat >> 1);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const float* s0 = s + 8 * kc;
      const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                              pack_bf16(s0[4], s0[5]), pack_bf16(s0[6], s0[7])};
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        if (j < nd) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vl + 16 * kc * LDS + 8 * j);
          mma_bf16(o + 4 * j, pa, vb[0], vb[1]);
          mma_bf16(o + 4 * j + 4, pa, vb[2], vb[3]);
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this stage may be refilled
  }
  store_rows<T, ND>(p, o, l, w.b, w.h, qw, D, nd, g, t);
}

template <typename Kernel>
cudaError_t launch_tc(Kernel kernel, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + kBQ - 1) / kBQ;
  const long long grid = (long long)nq * p.B * p.H;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kMmaThreads, smem, stream>>>(p, nq);
  return cudaGetLastError();
}

// the tensor-core design for head dims up to DMAX; D == DMAX has its own
// instantiation, without the guards of a ragged D
template <typename T, int DMAX, int MINB>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = WgmmaShape<DMAX>::smem_bytes();
    return p.D == DMAX ? launch_tc(flash_fwd_kernel_wgmma<DMAX, true, MINB>, smem, p, stream)
                       : launch_tc(flash_fwd_kernel_wgmma<DMAX, false, MINB>, smem, p, stream);
  } else {
    const size_t smem = Bf16Shape<DMAX>::smem_bytes();
    return p.D == DMAX ? launch_tc(flash_fwd_kernel_mma<DMAX, true, MINB>, smem, p, stream)
                       : launch_tc(flash_fwd_kernel_mma<DMAX, false, MINB>, smem, p, stream);
  }
}

// ---------------------------------------------------------------------------
// 128 < D <= 512: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

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

// Thread (ty, tx) owns query rows ty*TM .. ty*TM+TM-1, the score columns
// tx + 16*j and the output columns tx*4 + 64*j .. +3, so each row's max and
// sum reduce across 16 lanes of one warp; Q, K and V are held as f32 in
// shared memory (a product of two bf16 values is exact in f32).
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

// The design is chosen by D alone (heat_tpu_torch/ops/flash.py::kernel_design
// mirrors it): the tensor cores up to 128, the CUDA cores above.
template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (p.D <= 64) return launch_mma<T, 64, 2>(p, stream);
  if (p.D <= 128) return launch_mma<T, 128, kF32 ? 1 : 2>(p, stream);
  if (p.D <= 256) return launch<32, 32, 256, T>(p, stream);
  return launch<16, 32, 512, T>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// One launch over all of B*H. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                    int SK, int D, long long qsb, long long qss, long long qsh, long long ksb,
                    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                    float scale, int causal, int bf16, void* stream) {
  if (B < 0 || H < 0 || S < 0 || SK < 0 || D < 1 || D > 512) return (int)cudaErrorInvalidValue;
  const long long per16 = bf16 ? 8 : 4;  // elements per 16 bytes
  bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  for (long long st : {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh}) vec = vec && st % per16 == 0;
  const Params p{q,   k,   v,   o,   B,   H,   S,     SK,     D,          qsb, qss,
                 qsh, ksb, kss, ksh, vsb, vss, vsh, scale, causal, vec ? 1 : 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s));
}

}  // extern "C"

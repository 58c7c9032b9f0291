// One Lloyd accumulation pass for k-means, for NVIDIA Hopper (sm_90a).
//
// Replaces heat_tpu/ops/lloyd.py::_lloyd_kernel (the Pallas TPU kernel that
// heat_tpu's KMeans.fit runs once per iteration). From row-major data
// x (n_rows, f), f32 or bf16, centers c (k, f) f32 and a count n_valid of
// leading rows to use, it computes
//
//     score[r][c] = |c|^2 - 2 c.x_r     (|c|^2 from the unquantized f32 centers)
//     label[r]    = argmin_c score      (ties to the lowest index)
//     sums[c]    += x_r over rows with label c     (k, f)
//     counts[c]  += 1                               (k)
//     inertia    += min_c score                     (without sum |x|^2)
//
// all accumulated in f32. For bf16 data the dot's operands are bf16 (the
// centers are rounded to bf16, as the TPU kernel does) and the dot sums in
// f32. Rows at index >= n_valid are never read: the padding of a sharded
// array holds unspecified content, NaN and inf included.
//
// What bounds it: HBM bytes. An iteration must read the data once,
// n*f*itemsize bytes; everything else (centers, partials) is KBs. At f=16,
// k=8 the arithmetic is ~2*k*f = 256 flops per 64-byte row, far below what
// would make the ALUs the limit. So the design reads each row from device
// memory exactly once per iteration and keeps everything else on chip:
//
//  * Each CTA walks a contiguous range of rows in tiles of R rows. A tile is
//    loaded with coalesced 16-byte loads (when f allows) into shared memory
//    as f32, scored against
//    the centers (held in shared memory when they fit, else read through
//    L1/L2), and folded into the CTA's partial sums.
//  * The partial sums live in shared memory in G copies; thread (g, j) owns
//    column j of copy g and adds the tile's rows g, g+G, ... in order. No two
//    threads write one address, so there are no atomics, and the order of
//    every sum is fixed. When k*f floats do not fit in shared memory
//    (f=512, k=128 needs 256 KB, past the 227 KB a block may use), G = 1 and
//    the partial lives in the CTA's own slice of the global scratch, with
//    the same ownership rule.
//  * At the main path's shape (f=16, k<=8) a second variant gives each
//    pair of threads whole rows instead: the row goes straight into
//    registers and the partial sums stay in registers (lloyd_rows_kernel).
//  * Each CTA writes its (k*f + k + 1) partial to the scratch; a second
//    kernel sums the partials over CTAs in a fixed order. The grid is a fixed
//    function of (n_valid, f, k) and the card's SM count, so a result
//    repeats bit for bit from run to run, as the reference's does.
//
// The C interface takes raw pointers and a stream and returns the CUDA
// error code of the launches; heat_tpu_torch/ops/lloyd.py binds it with
// ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 200 * 1024;    // of the 227 KB a block may use
constexpr int kCentersSmemMax = 64 * 1024;  // larger centers are read through L1/L2
constexpr int kTileElems = 8192;            // bounds R*f and R*k

struct Plan {
  int rows;       // the one-thread-per-row kernel (f = kRowF, k <= kRowK)
  int R;          // rows per tile
  int XS;         // row stride of the tile in shared memory (odd: no bank conflicts)
  int G;          // copies of the partial sums
  int c_in_smem;  // centers held in shared memory
  int p_in_smem;  // partial sums held in shared memory
  int smem;       // dynamic shared memory bytes
  int grid;       // CTAs
  long long rows_per_cta;
  int stride;     // floats per CTA partial: k*f + k + 1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of one row: 4 f32 or 8 bf16 values, as f32
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    o[2 * i] = t.x;
    o[2 * i + 1] = t.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_partial_kernel(const T* __restrict__ x, const float* __restrict__ centers,
                     long long n_valid, int f, int k, int R, int XS, int G, int c_in_smem,
                     int p_in_smem, long long rows_per_cta, float* __restrict__ partials,
                     int stride, int* __restrict__ labels_out, int vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int kf = k * f;
  float* xs = smem;                           // R * XS
  float* scores = xs + R * XS;                // k * R
  float* mins = scores + k * R;               // R
  int* labels = reinterpret_cast<int*>(mins + R);  // R
  float* csq = reinterpret_cast<float*>(labels + R);  // k
  float* red = csq + k;                       // kThreads
  float* cnt = red + kThreads;                // G * k
  float* cs = cnt + G * k;                    // k * f when c_in_smem
  float* out = partials + (size_t)blockIdx.x * stride;
  float* P = p_in_smem ? cs + (c_in_smem ? kf : 0) : out;  // G * k * f
  const int tid = threadIdx.x;

  for (int c = tid; c < k; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < f; ++j) {
      const float v = centers[c * f + j];
      s = fmaf(v, v, s);
    }
    csq[c] = s;
  }
  if (c_in_smem) {
    for (int e = tid; e < kf; e += kThreads) {
      cs[e] = kBf16 ? round_bf16(centers[e]) : centers[e];
    }
  }
  for (int e = tid; e < G * kf; e += kThreads) P[e] = 0.f;
  for (int e = tid; e < G * k; e += kThreads) cnt[e] = 0.f;
  __syncthreads();

  // thread (g, j): copy g of the partial, columns j, j + jstep, ...
  const int g = tid / f;
  const int jt = tid % f;
  const int jstep = f < kThreads ? f : kThreads;
  float inertia = 0.f;  // row slot tid of every tile: a fixed order

  const long long start = (long long)blockIdx.x * rows_per_cta;
  long long stop = start + rows_per_cta;
  if (stop > n_valid) stop = n_valid;
  for (long long row0 = start; row0 < stop; row0 += R) {
    const int rows = (int)(stop - row0 < R ? stop - row0 : R);
    const T* src = x + row0 * f;
    const int tile = rows * f;
    if (vec) {
      // f is a multiple of kVec: each 16-byte load lies within one row
      for (int e = tid * kVec; e < tile; e += kThreads * kVec) {
        float v[kVec];
        load16(src + e, v);
        const int r = e / f;
        float* dst = xs + r * XS + (e - r * f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) dst[i] = v[i];
      }
    } else {
      for (int e = tid; e < tile; e += kThreads) {
        const int r = e / f;
        xs[r * XS + (e - r * f)] = to_f32(src[e]);
      }
    }
    __syncthreads();

    // scores: consecutive threads take consecutive rows against one center
    for (int p = tid; p < k * rows; p += kThreads) {
      const int c = p / rows;
      const int r = p - c * rows;
      const float* xr = xs + r * XS;
      float d = 0.f;
      if (c_in_smem || !kBf16) {
        const float* cr = (c_in_smem ? cs : centers) + c * f;
#pragma unroll 8
        for (int j = 0; j < f; ++j) d = fmaf(xr[j], cr[j], d);
      } else {
        const float* cr = centers + c * f;
#pragma unroll 8
        for (int j = 0; j < f; ++j) d = fmaf(xr[j], round_bf16(cr[j]), d);
      }
      scores[c * R + r] = csq[c] - 2.f * d;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += kThreads) {
      float best = scores[r];
      int bi = 0;
      for (int c = 1; c < k; ++c) {
        const float s = scores[c * R + r];
        if (s < best) {
          best = s;
          bi = c;
        }
      }
      labels[r] = bi;
      mins[r] = best;
      inertia += best;
      if (labels_out != nullptr) labels_out[row0 + r] = bi;
    }
    __syncthreads();

    if (g < G) {
      float* Pg = P + g * kf;
      float* cg = cnt + g * k;
      for (int r = g; r < rows; r += G) {
        const int l = labels[r];
        const float* xr = xs + r * XS;
        for (int j = jt; j < f; j += jstep) Pg[l * f + j] += xr[j];
        if (jt == 0) cg[l] += 1.f;
      }
    }
    __syncthreads();
  }

  red[tid] = inertia;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += red[i];
    out[kf + k] = s;
  }
  if (p_in_smem) {
    for (int e = tid; e < kf; e += kThreads) {
      float s = 0.f;
      for (int q = 0; q < G; ++q) s += P[q * kf + e];
      out[e] = s;
    }
  }
  for (int c = tid; c < k; c += kThreads) {
    float s = 0.f;
    for (int q = 0; q < G; ++q) s += cnt[q * k + c];
    out[kf + c] = s;
  }
}

// The main path's shape, f = kRowF and k <= kRowK: a pair of threads per
// row, each holding half of the row's features. The half-row is loaded
// straight into registers (the next one is fetched while this one is
// scored), the centers are read from shared memory as broadcasts, the two
// halves of each dot product are joined with one shuffle, and the sums,
// counts and inertia stay in registers. Pair p of a CTA takes rows
// start + p, start + p + kRowPairs, ... in order; at the end each value is
// summed over a warp's lanes by a fixed shuffle tree and over the warps in
// order, so the order of every sum is fixed. Clusters k..kRowK-1 get an
// infinite |c|^2 and are never chosen.
constexpr int kRowF = 16;
constexpr int kRowK = 8;
constexpr int kRowThreads = 256;
constexpr int kRowHalf = kRowF / 2;            // features per thread
constexpr int kRowPairs = kRowThreads / 2;     // rows per CTA step
constexpr int kRowVals = kRowK * kRowF + kRowK + 1;

template <typename T>
__device__ __forceinline__ void load_half_row(const T* p, float* o, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRowHalf; j += kVec) load16(p + j, o + j);
  } else {
#pragma unroll
    for (int j = 0; j < kRowHalf; ++j) o[j] = to_f32(p[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads, 2)
lloyd_rows_kernel(const T* __restrict__ x, const float* __restrict__ centers, long long n_valid,
                  int k, long long rows_per_cta, float* __restrict__ partials,
                  int* __restrict__ labels_out, int vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float cs[kRowK * kRowF];
  __shared__ float csq[kRowK];
  __shared__ float wsum[kRowThreads / 32][kRowVals];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int half = tid % 2;
  if (tid < kRowK) {
    float s = __int_as_float(0x7f800000);  // +inf: a cluster past k
    if (tid < k) {
      s = 0.f;
      for (int j = 0; j < kRowF; ++j) s = fmaf(centers[tid * kRowF + j], centers[tid * kRowF + j], s);
    }
    csq[tid] = s;
  }
  for (int e = tid; e < kRowK * kRowF; e += kRowThreads) {
    const float v = e < k * kRowF ? centers[e] : 0.f;
    cs[e] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  float acc[kRowK][kRowHalf];
  float cnt[kRowK];
#pragma unroll
  for (int c = 0; c < kRowK; ++c) {
    cnt[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kRowHalf; ++j) acc[c][j] = 0.f;
  }
  float inertia = 0.f;

  const long long start = (long long)blockIdx.x * rows_per_cta;
  long long stop = start + rows_per_cta;
  if (stop > n_valid) stop = n_valid;
  // the loop runs while the warp's first row is in range, the same trip
  // count for every lane of the warp, as the shuffles need
  const long long warp_row0 = start + warp * 16;
  const long long pair_row0 = start + tid / 2;
  const T* xh = x + half * kRowHalf;
  float nxt[kRowHalf];
#pragma unroll
  for (int j = 0; j < kRowHalf; ++j) nxt[j] = 0.f;
  if (pair_row0 < stop) load_half_row(xh + pair_row0 * kRowF, nxt, vec);
  for (long long i = 0; warp_row0 + i < stop; i += kRowPairs) {
    const long long r = pair_row0 + i;
    const bool valid = r < stop;
    float cur[kRowHalf];
#pragma unroll
    for (int j = 0; j < kRowHalf; ++j) cur[j] = nxt[j];
    if (r + kRowPairs < stop) load_half_row(xh + (r + kRowPairs) * kRowF, nxt, vec);

    float best = 0.f;
    int bi = 0;
#pragma unroll
    for (int c = 0; c < kRowK; ++c) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kRowHalf; ++j) d = fmaf(cur[j], cs[c * kRowF + half * kRowHalf + j], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      const float sc = csq[c] - 2.f * d;
      if (c == 0 || sc < best) {
        best = sc;
        bi = c;
      }
    }
    if (valid) {
      inertia += best;
#pragma unroll
      for (int c = 0; c < kRowK; ++c) {
        const bool hit = bi == c;
        cnt[c] += hit ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < kRowHalf; ++j) acc[c][j] += hit ? cur[j] : 0.f;
      }
      if (labels_out != nullptr && half == 0) labels_out[r] = bi;
    }
  }

  // lanes of one parity hold one half of the features: sum with offsets
  // 16..2, so lane 0 gets the even lanes (half 0) and lane 1 the odd ones.
  // The counts and inertia are the same on both threads of a pair: lane 0's.
  auto pair_sum = [](float v) {
#pragma unroll
    for (int off = 16; off > 1; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
  };
#pragma unroll
  for (int c = 0; c < kRowK; ++c) {
#pragma unroll
    for (int j = 0; j < kRowHalf; ++j) {
      const float v = pair_sum(acc[c][j]);
      if (lane < 2) wsum[warp][c * kRowF + lane * kRowHalf + j] = v;
    }
    const float v = pair_sum(cnt[c]);
    if (lane == 0) wsum[warp][kRowK * kRowF + c] = v;
  }
  const float v = pair_sum(inertia);
  if (lane == 0) wsum[warp][kRowVals - 1] = v;
  __syncthreads();

  // out: k*f sums, k counts, the inertia (the tiled kernel's layout)
  float* out = partials + (size_t)blockIdx.x * (k * kRowF + k + 1);
  for (int e = tid; e < k * kRowF + k + 1; e += kRowThreads) {
    const int src = e < k * kRowF ? e : e < k * kRowF + k ? kRowK * kRowF + (e - k * kRowF)
                                                          : kRowVals - 1;
    float s = 0.f;
    for (int w = 0; w < kRowThreads / 32; ++w) s += wsum[w][src];
    out[e] = s;
  }
}

// out[e] = sum over CTAs b of partials[b][e], one warp per element: lane l
// sums CTAs l, l + 32, ... in order, then a fixed shuffle tree. The order
// never changes, so neither does the result.
__global__ void lloyd_reduce_kernel(const float* __restrict__ partials, int grid, int stride,
                                    float* __restrict__ out) {
  const int e = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= stride) return;  // e is the same for the whole warp
  float s = 0.f;
  for (int b = lane; b < grid; b += 32) s += partials[(size_t)b * stride + e];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = s;
}

template <typename T>
cudaError_t make_rows_plan(long long n_valid, int k, Plan* p) {
  p->rows = 1;
  p->stride = k * kRowF + k + 1;
  p->smem = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lloyd_rows_kernel<T>,
                                                           kRowThreads, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (long long)sms * per_sm;
  const long long steps = (n_valid + kRowPairs - 1) / kRowPairs;  // a CTA step of rows each
  if (steps < grid) grid = steps;
  if (grid < 1) grid = 1;
  p->rows_per_cta = n_valid > 0 ? (n_valid + grid - 1) / grid : 1;
  p->grid = (int)(n_valid > 0 ? (n_valid + p->rows_per_cta - 1) / p->rows_per_cta : 1);
  return cudaSuccess;
}

template <typename T>
cudaError_t make_plan(long long n_valid, int f, int k, Plan* p) {
  if (f == kRowF && k <= kRowK) return make_rows_plan<T>(n_valid, k, p);
  p->rows = 0;
  int R = kTileElems / f < kTileElems / k ? kTileElems / f : kTileElems / k;
  if (R > kThreads) R = kThreads;  // the argmin gives each row slot one thread
  p->R = R;
  p->XS = f | 1;
  const int kf = k * f;
  const int base = 4 * (R * p->XS + k * R + R + R + k + kThreads);
  p->c_in_smem = 4 * kf <= kCentersSmemMax;
  const int avail = kSmemBudget - base - (p->c_in_smem ? 4 * kf : 0);
  int G = kThreads / f > 1 ? kThreads / f : 1;
  const int fit = avail / (4 * kf + 4 * k);
  if (fit < G) G = fit;
  p->p_in_smem = G >= 1;
  p->G = G >= 1 ? G : 1;
  p->smem = base + 4 * p->G * k + (p->c_in_smem ? 4 * kf : 0) + (p->p_in_smem ? 4 * p->G * kf : 0);
  p->stride = kf + k + 1;

  cudaError_t err = cudaFuncSetAttribute(lloyd_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lloyd_partial_kernel<T>,
                                                           kThreads, p->smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (n_valid + R - 1) / R;
  long long grid = (long long)sms * per_sm;
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  const long long tiles_per_cta = tiles > 0 ? (tiles + grid - 1) / grid : 1;
  p->rows_per_cta = tiles_per_cta * R;
  p->grid = (int)(tiles > 0 ? (tiles + tiles_per_cta - 1) / tiles_per_cta : 1);
  return cudaSuccess;
}

// make_plan, remembered for the last (device, n_valid, f, k) of each
// calling thread: an iteration loop launches the same plan every time
template <typename T>
cudaError_t cached_plan(long long n_valid, int f, int k, Plan* p) {
  thread_local Plan plan;
  thread_local long long key_n = -1;
  thread_local int key_dev = -1, key_f = 0, key_k = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != key_dev || n_valid != key_n || f != key_f || k != key_k) {
    if ((err = make_plan<T>(n_valid, f, k, &plan)) != cudaSuccess) return err;
    key_dev = dev;
    key_n = n_valid;
    key_f = f;
    key_k = k;
  }
  *p = plan;
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* centers, long long n_valid, int f, int k, int grid,
           void* partials, void* out, void* labels_out, void* stream) {
  Plan p;
  cudaError_t err = cached_plan<T>(n_valid, f, k, &p);
  if (err != cudaSuccess) return (int)err;
  if (grid != p.grid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  const int vec = f % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (p.rows) {
    lloyd_rows_kernel<T><<<p.grid, kRowThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(centers), n_valid, k,
        p.rows_per_cta, static_cast<float*>(partials), static_cast<int*>(labels_out), vec);
  } else {
    lloyd_partial_kernel<T><<<p.grid, kThreads, p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(centers), n_valid, f, k, p.R, p.XS,
        p.G, p.c_in_smem, p.p_in_smem, p.rows_per_cta, static_cast<float*>(partials), p.stride,
        static_cast<int*>(labels_out), vec);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lloyd_reduce_kernel<<<(p.stride + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(partials), p.grid, p.stride, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid and the floats per CTA partial that lloyd_accumulate will use:
// the caller allocates grid * stride floats of scratch.
int lloyd_plan(long long n_valid, int f, int k, int is_bf16, int* grid, int* stride) {
  Plan p;
  cudaError_t err = is_bf16 ? make_plan<__nv_bfloat16>(n_valid, f, k, &p)
                            : make_plan<float>(n_valid, f, k, &p);
  if (err != cudaSuccess) return (int)err;
  *grid = p.grid;
  *stride = p.stride;
  return 0;
}

// x: (>= n_valid, f) row-major f32 or bf16; centers: (k, f) f32;
// partials: grid * stride f32 scratch; out: k*f sums, then k counts, then
// the inertia, f32; labels_out: n_valid int32, or null.
int lloyd_accumulate(const void* x, const void* centers, long long n_valid, int f, int k,
                     int is_bf16, int grid, void* partials, void* out, void* labels_out,
                     void* stream) {
  if (f < 1 || f > 512 || k < 1 || k > 128 || n_valid < 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch<__nv_bfloat16>(x, centers, n_valid, f, k, grid, partials, out,
                                         labels_out, stream)
                 : launch<float>(x, centers, n_valid, f, k, grid, partials, out, labels_out,
                                 stream);
}

}  // extern "C"

// Fused envelope -> threshold -> local maxima -> slotting -> exact
// prominence pick kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_picks_kernel` of
// das4whales_tpu/ops/pallas_picks.py (launched by its `pl.pallas_call`),
// which runs das4whales_tpu/ops/peaks.py:_find_peaks_rows on a VMEM
// block of 8 rows. This kernel computes the same function, row by row;
// it does not carry the Pallas block layout over.
//
// Per row of the analytic signal X [rows, T] (complex64, read as float2):
//   env = sqrt(re*re + im*im), each operation rounded on its own
//         (__fmul_rn/__fadd_rn/__fsqrt_rn), so env equals PyTorch's eager
//         torch.sqrt(re*re + im*im) bit for bit;
//   candidates = scipy plateau-exact local maxima with env >= thr[row];
//   slots: method 0 "pack" keeps the first K candidates in time order,
//          method 1 "topk" keeps the K tallest (ties toward the lower
//          index, as lax.top_k), then orders the slots by
//          (selected ? position : T, top_k rank);
//   prominence = h - max(left base min, right base min), exact scipy;
//   selected = valid & prominence >= thr; saturated = n_cand > K.
// Outputs: positions [rows, K] int32 (T where not selected), heights and
// prominences [rows, K] float32, selected [rows, K] and saturated [rows]
// as bytes (torch.bool).
//
// Bound. At the main path's launch (rows = 2 templates x 512-channel
// tile = 1024, T = 12000) the kernel must read rows*T*8 bytes of analytic
// signal, 98.3 MB, and write a few MB at most: about 29 us at the H100's
// 3.35 TB/s. Its arithmetic (the envelope, a compare per sample, K short
// walks) is far below the float32 rate, so it is bound by bytes. The
// design reads each sample from device memory once: one CTA per row
// keeps the row's envelope in shared memory (48 KB at T = 12000) with
// the per-block max/min tables of nb samples and the candidate slots,
// and every later phase works from shared memory. The envelope never
// reaches device memory.
//
// Prominences: one warp per slot walks left through its own block, then
// skips whole blocks whose max is <= h while folding their mins, then
// takes the suffix min of the block that holds the previous greater
// sample; then the same to the right. That is exactly scipy's walk, and
// exact with any blocking, since min and max round nothing.
//
// Unfilled slots (h = -inf) report prominence -inf - env[0] (= -inf for
// finite input), as the plain version does for its fill position.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScratch = kWarps + 8;

struct Layout {
  int T, K, nb, B, cmax;
  size_t env, bmax, bmin, cand, slot_pos, slot_h, slot_prom, slot_sel,
      sel_list, hist, scratch, flags, bytes;
};

__host__ __device__ inline Layout make_layout(int T, int K, int nb) {
  Layout L;
  L.T = T;
  L.K = K;
  L.nb = nb;
  L.B = (T + nb - 1) / nb;
  L.cmax = T / 2 + 1;  // local maxima are separated by >= 1 sample
  size_t o = 0;
  L.env = o;       o += 4 * (size_t)T;
  L.bmax = o;      o += 4 * (size_t)L.B;
  L.bmin = o;      o += 4 * (size_t)L.B;
  L.cand = o;      o += 4 * (size_t)L.cmax;
  L.slot_pos = o;  o += 4 * (size_t)K;
  L.slot_h = o;    o += 4 * (size_t)K;
  L.slot_prom = o; o += 4 * (size_t)K;
  L.slot_sel = o;  o += 4 * (size_t)K;
  L.sel_list = o;  o += 4 * (size_t)K;
  L.hist = o;      o += 4 * 256;
  L.scratch = o;   o += 4 * kScratch;
  L.flags = o;     o += (size_t)T;
  L.bytes = (o + 15) & ~(size_t)15;
  return L;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// exclusive block-wide prefix sum of v; *total gets the sum over the block
__device__ int block_excl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return excl;
}

// float -> unsigned with the same order (the sign bit flips the rest)
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// min of env over (j, p] with j the last index < p where env[j] > h
__device__ float left_base_min(const float* env, const float* bmax,
                               const float* bmin, int p, float h, int nb) {
  const int lane = threadIdx.x & 31;
  float m = env[p];
  const int b = p / nb;
  const int bstart = b * nb;
  for (int hi = p - 1; hi >= bstart; hi -= 32) {
    const int i = hi - lane;
    const bool in = i >= bstart;
    const float v = in ? env[i] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && v > h);
    if (gt) {
      const int first = __ffs(gt) - 1;  // lowest lane: the highest index
      return fminf(m, warp_min(lane < first ? v : INFINITY));
    }
    m = fminf(m, warp_min(v));
  }
  for (int bhi = b - 1; bhi >= 0; bhi -= 32) {
    const int bb = bhi - lane;
    const bool in = bb >= 0;
    const unsigned gt = __ballot_sync(kFull, in && bmax[bb] > h);
    if (!gt) {
      m = fminf(m, warp_min(in ? bmin[bb] : INFINITY));
      continue;
    }
    const int first = __ffs(gt) - 1;
    m = fminf(m, warp_min(lane < first ? bmin[bb] : INFINITY));
    const int bp = bhi - first;  // a full block: it lies before block b
    for (int hi = bp * nb + nb - 1; hi >= bp * nb; hi -= 32) {
      const int i = hi - lane;
      const bool in2 = i >= bp * nb;
      const float v = in2 ? env[i] : INFINITY;
      const unsigned g2 = __ballot_sync(kFull, in2 && v > h);
      if (g2) {
        const int f2 = __ffs(g2) - 1;
        return fminf(m, warp_min(lane < f2 ? v : INFINITY));
      }
      m = fminf(m, warp_min(v));
    }
    return m;  // not reached: bmax[bp] > h
  }
  return m;
}

// min of env over [p, j) with j the first index > p where env[j] > h
__device__ float right_base_min(const float* env, const float* bmax,
                                const float* bmin, int p, float h, int nb,
                                int T, int B) {
  const int lane = threadIdx.x & 31;
  float m = env[p];
  const int b = p / nb;
  const int bend = min(b * nb + nb, T);  // exclusive
  for (int lo = p + 1; lo < bend; lo += 32) {
    const int i = lo + lane;
    const bool in = i < bend;
    const float v = in ? env[i] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && v > h);
    if (gt) {
      const int first = __ffs(gt) - 1;  // lowest lane: the lowest index
      return fminf(m, warp_min(lane < first ? v : INFINITY));
    }
    m = fminf(m, warp_min(v));
  }
  for (int blo = b + 1; blo < B; blo += 32) {
    const int bb = blo + lane;
    const bool in = bb < B;
    const unsigned gt = __ballot_sync(kFull, in && bmax[bb] > h);
    if (!gt) {
      m = fminf(m, warp_min(in ? bmin[bb] : INFINITY));
      continue;
    }
    const int first = __ffs(gt) - 1;
    m = fminf(m, warp_min(lane < first ? bmin[bb] : INFINITY));
    const int bn = blo + first;
    const int end = min(bn * nb + nb, T);
    for (int lo = bn * nb; lo < end; lo += 32) {
      const int i = lo + lane;
      const bool in2 = i < end;
      const float v = in2 ? env[i] : INFINITY;
      const unsigned g2 = __ballot_sync(kFull, in2 && v > h);
      if (g2) {
        const int f2 = __ffs(g2) - 1;
        return fminf(m, warp_min(lane < f2 ? v : INFINITY));
      }
      m = fminf(m, warp_min(v));
    }
    return m;  // not reached: bmax[bn] > h
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
fused_picks_kernel(const float2* __restrict__ X, const float* __restrict__ thr_in,
                   int32_t* __restrict__ pos_out, float* __restrict__ h_out,
                   float* __restrict__ prom_out, uint8_t* __restrict__ sel_out,
                   uint8_t* __restrict__ sat_out, int T, int K, int method,
                   int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(T, K, nb);
  float* env = reinterpret_cast<float*>(smem + L.env);
  float* bmax = reinterpret_cast<float*>(smem + L.bmax);
  float* bmin = reinterpret_cast<float*>(smem + L.bmin);
  int* cand = reinterpret_cast<int*>(smem + L.cand);
  int* slot_pos = reinterpret_cast<int*>(smem + L.slot_pos);
  float* slot_h = reinterpret_cast<float*>(smem + L.slot_h);
  float* slot_prom = reinterpret_cast<float*>(smem + L.slot_prom);
  int* slot_sel = reinterpret_cast<int*>(smem + L.slot_sel);
  int* sel_list = reinterpret_cast<int*>(smem + L.sel_list);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);
  uint8_t* flags = smem + L.flags;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float2* x = X + row * (size_t)T;
  const float thr = thr_in[row];
  const int B = L.B;

  // 1. envelope into shared memory (the only read of device memory)
  for (int i = tid; i < T; i += kThreads) {
    const float2 v = x[i];
    env[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
    flags[i] = 0;
  }
  __syncthreads();

  // 2. per-block max/min tables
  for (int b = warp; b < B; b += kWarps) {
    float mx = -INFINITY, mn = INFINITY;
    for (int j = lane; j < nb; j += 32) {
      const int i = b * nb + j;
      if (i < T) {
        mx = fmaxf(mx, env[i]);
        mn = fminf(mn, env[i]);
      }
    }
    mx = warp_max(mx);
    mn = warp_min(mn);
    if (lane == 0) {
      bmax[b] = mx;
      bmin[b] = mn;
    }
  }

  // 3. plateau-exact local maxima: the thread at a strict rise walks its
  //    run; a run that reaches the right edge is no maximum; the peak is
  //    the floor-midpoint of the run
  for (int i = tid + 1; i < T; i += kThreads) {
    const float v = env[i];
    if (env[i - 1] < v) {
      int j = i + 1;
      while (j < T && env[j] == v) ++j;
      if (j < T && env[j] < v && v >= thr) flags[(i + j - 1) >> 1] = 1;
    }
  }
  __syncthreads();

  // 4. candidates in time order: chunked count, block scan, compaction
  const int chunk = (T + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, T), hi = min(lo + chunk, T);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += flags[i];
  int n_cand;
  int w = block_excl_scan(c, scratch, &n_cand);
  for (int i = lo; i < hi; ++i)
    if (flags[i]) cand[w++] = i;
  __syncthreads();

  // 5. slots
  int nS;
  if (method == 0) {  // pack: the first K candidates in time order
    nS = min(n_cand, K);
    for (int s = tid; s < K; s += kThreads) {
      slot_pos[s] = s < nS ? cand[s] : 0;
      slot_h[s] = s < nS ? env[cand[s]] : -INFINITY;
    }
  } else {  // topk: the K tallest, ties toward the lower index
    const int* S = cand;
    nS = min(n_cand, K);
    if (n_cand > K) {
      // radix select of the K-th largest key, 8 bits at a time
      unsigned prefix = 0, mask = 0;
      int k_rem = K;
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
        __syncthreads();
        for (int i = tid; i < n_cand; i += kThreads) {
          const unsigned u = order_key(env[cand[i]]);
          if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
        }
        __syncthreads();
        if (tid == 0) {
          unsigned above = 0;
          int b = 255;
          for (; b > 0; --b) {
            if (above + hist[b] >= (unsigned)k_rem) break;
            above += hist[b];
          }
          scratch[kWarps] = k_rem - (int)above;
          scratch[kWarps + 1] = (int)(prefix | ((unsigned)b << shift));
        }
        __syncthreads();
        k_rem = scratch[kWarps];
        prefix = (unsigned)scratch[kWarps + 1];
        mask |= 255u << shift;
        __syncthreads();
      }
      // keys above the K-th all go in; of the keys equal to it, the
      // first k_rem in index order
      const int cchunk = (n_cand + kThreads - 1) / kThreads;
      const int clo = min(tid * cchunk, n_cand), chi = min(clo + cchunk, n_cand);
      int eq = 0;
      for (int i = clo; i < chi; ++i) eq += order_key(env[cand[i]]) == prefix;
      int n_eq;
      int tie = block_excl_scan(eq, scratch, &n_eq);
      int take = 0;
      for (int i = clo, t = tie; i < chi; ++i) {
        const unsigned u = order_key(env[cand[i]]);
        if (u > prefix) ++take;
        else if (u == prefix) take += (t++ < k_rem);
      }
      int n_take;
      int dst = block_excl_scan(take, scratch, &n_take);
      for (int i = clo, t = tie; i < chi; ++i) {
        const unsigned u = order_key(env[cand[i]]);
        bool in = u > prefix;
        if (u == prefix) in = (t++ < k_rem);
        if (in) sel_list[dst++] = cand[i];
      }
      __syncthreads();
      S = sel_list;
    }
    // top_k order among the kept: height descending, then index ascending
    for (int i = tid; i < nS; i += kThreads) {
      const int p = S[i];
      const unsigned u = order_key(env[p]);
      int r = 0;
      for (int j = 0; j < nS; ++j) {
        const int q = S[j];
        const unsigned v = order_key(env[q]);
        r += (v > u) || (v == u && q < p);
      }
      slot_pos[r] = p;
      slot_h[r] = env[p];
    }
    for (int s = nS + tid; s < K; s += kThreads) {
      slot_pos[s] = 0;
      slot_h[s] = -INFINITY;
    }
  }
  __syncthreads();

  // 6. exact prominences, one warp per slot
  for (int s = warp; s < K; s += kWarps) {
    const int p = slot_pos[s];
    const float h = slot_h[s];
    const float lmin = left_base_min(env, bmax, bmin, p, h, nb);
    const float rmin = right_base_min(env, bmax, bmin, p, h, nb, T, B);
    if (lane == 0) {
      const float prom = __fsub_rn(h, fmaxf(lmin, rmin));
      const bool valid = method == 0 ? s < nS : isfinite(h);
      slot_prom[s] = prom;
      slot_sel[s] = valid && prom >= thr;
    }
  }
  __syncthreads();

  // 7. outputs: pack keeps slot order; topk orders the slots by
  //    (selected ? position : T), stable in slot order
  const size_t base = row * (size_t)K;
  for (int s = tid; s < K; s += kThreads) {
    const bool sel = slot_sel[s] != 0;
    int dst = s;
    if (method != 0) {
      int before = 0, nsel = 0, unsel_before = 0;
      for (int j = 0; j < K; ++j) {
        const bool sj = slot_sel[j] != 0;
        nsel += sj;
        before += sj && slot_pos[j] < slot_pos[s];
        unsel_before += !sj && j < s;
      }
      dst = sel ? before : nsel + unsel_before;
    }
    pos_out[base + dst] = sel ? slot_pos[s] : T;
    h_out[base + dst] = slot_h[s];
    prom_out[base + dst] = slot_prom[s];
    sel_out[base + dst] = sel;
  }
  if (tid == 0) sat_out[row] = n_cand > K;
}

}  // namespace

extern "C" {

// dynamic shared memory one CTA needs for a row of T samples at K slots
long long fused_picks_smem_bytes(int T, int K, int nb) {
  return (long long)make_layout(T, K, nb).bytes;
}

// the most dynamic shared memory a block may opt in to on this device
int fused_picks_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return limit;
}

const char* fused_picks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
int fused_picks_launch(const void* X, const void* thr, void* pos, void* heights,
                       void* prom, void* sel, void* sat, int rows, int T, int K,
                       int method, int nb, void* stream) {
  const size_t bytes = make_layout(T, K, nb).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_picks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  fused_picks_kernel<<<rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(X), static_cast<const float*>(thr),
      static_cast<int32_t*>(pos), static_cast<float*>(heights),
      static_cast<float*>(prom), static_cast<uint8_t*>(sel),
      static_cast<uint8_t*>(sat), T, K, method, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"

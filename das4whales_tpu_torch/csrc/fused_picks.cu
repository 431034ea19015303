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
// signal, 98.3 MB, and write a few MB at most: about 29.6 us at the
// H100's 3.35 TB/s. Its arithmetic (the envelope, a compare per sample, K
// short walks) is far below the float32 rate, so it is bound by bytes.
// Each sample is read from device memory once: one CTA per row keeps the
// row's envelope in shared memory (48 KB at T = 12000) with the per-block
// max/min tables of nb samples, and every later phase works from shared
// memory. The envelope never reaches device memory.
//
// Long rows. A row whose shared layout exceeds the device's opt-in limit
// (about 55k samples at K = 256; the envelope alone is 4 T bytes) takes
// the long-row form: the envelope, the block tables and the candidate
// bits live in a device-memory workspace of the caller's, one 16-byte
// aligned slice a row, and only the slots, the histogram and the scratch
// stay in shared memory. The phases and their arithmetic are the same, so
// the outputs are too; the envelope is written once and read back through
// L2 by the later phases.
//
// What bounded the first design (512 threads a CTA; times from its
// phase-timed instantiation at the main launch, pack K = 64, on an H100
// 80GB HBM3 at 700 W; PERF.md has the split): each CTA reserved 24 KB for
// a candidate list of T/2+1 ints and 12 KB for a byte flag a sample, so at
// 87 KB under two CTAs were resident an SM (1.88 on average). A CTA spent
// 11.3 us loading its row, one float2 a thread in flight, and 14.8 us in
// shared-memory phases (6.7 us of them in the tables and maxima), during
// which the SM had little else to load.
//
// This design:
// - candidates are one bit a sample (1.5 KB at T = 12000). A block scan
//   of the words' popcounts gives each candidate its rank in time order;
//   `pack` writes the candidate of rank s < K to slot s, `topk` runs its
//   radix select over the set bits, reading heights from env. A CTA needs
//   about 51 KB (`pack`, K = 64) or 56 KB (`topk`, K = 256);
// - 256 threads a CTA and at most 64 registers a thread for `pack`, so
//   four CTAs fit on an SM (`topk` K = 256 also four): twice the rows in
//   flight, in different phases, so one CTA's loads overlap another's
//   shared-memory phases;
// - loads of 16 bytes (two samples) a thread, kLoads in flight before
//   the first is used: 64 KB in flight an SM at four CTAs, where Little's law
//   at 3.35 TB/s asks about 18 KB. Registers, not a TMA or cp.async ring,
//   stage them: a ring of raw samples (8 bytes each) in shared memory
//   would take back the room the bitmask freed, and each sample is used
//   once, straight into the envelope;
// - the block tables and the maxima share one sweep of shared memory, a
//   float4 a lane (a warp per 128-sample block), the neighbours and the
//   candidate words assembled by shuffles.

// Prominences: one warp per slot walks left through its own block, then
// skips whole blocks whose max is <= h while folding their mins, then
// takes the suffix min of the block that holds the previous greater
// sample; then the same to the right. That is exactly scipy's walk, and
// exact with any blocking, since min and max round nothing. A `pack`
// slot past the candidates takes no walk.
//
// Unfilled slots (h = -inf) report prominence -inf - env[0] (= -inf for
// finite input), as the plain version does for its fill position.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // float4 loads in flight a thread before it uses one
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScratch = kWarps + 8;
constexpr int kPhases = 6;
constexpr int kMaxDevices = 64;  // devices whose opt-in prepare() records

struct Layout {
  int T, K, nb, B, W;
  // env, bmax, bmin and bits: offsets in shared memory, or (long rows) in
  // the row's workspace slice of `row_bytes`
  size_t env, bmax, bmin, bits, row_bytes, slot_pos, slot_h, slot_prom, slot_sel,
      sel_list, hist, scratch, bytes;
};

// method 0 (pack) keeps no selection list and no histogram; `long_row`
// moves the four row-sized arrays to the workspace
__host__ __device__ inline Layout make_layout(int T, int K, int nb, int method,
                                              bool long_row = false) {
  Layout L;
  L.T = T;
  L.K = K;
  L.nb = nb;
  L.B = (T + nb - 1) / nb;
  L.W = (T + 31) / 32;
  size_t o = 0;
  L.env = o;       o += 4 * (size_t)T;
  L.bmax = o;      o += 4 * (size_t)L.B;
  L.bmin = o;      o += 4 * (size_t)L.B;
  L.bits = o;      o += 4 * (size_t)L.W;
  L.row_bytes = long_row ? (o + 15) & ~(size_t)15 : 0;
  if (long_row) o = 0;
  L.slot_pos = o;  o += 4 * (size_t)K;
  L.slot_h = o;    o += 4 * (size_t)K;
  L.slot_prom = o; o += 4 * (size_t)K;
  L.slot_sel = o;  o += 4 * (size_t)K;
  L.sel_list = o;  if (method != 0) o += 4 * (size_t)K;
  L.hist = o;      if (method != 0) o += 4 * 256;
  L.scratch = o;   o += 4 * kScratch;
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

__device__ __forceinline__ float magnitude(float re, float im) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// f(p) for each candidate p of the words [wlo, whi), in index order
template <class F>
__device__ __forceinline__ void for_each_candidate(const unsigned* bits, int wlo,
                                                   int whi, F f) {
  for (int w = wlo; w < whi; ++w)
    for (unsigned m = bits[w]; m; m &= m - 1) f((w << 5) + __ffs(m) - 1);
}

// float -> unsigned with the same order (the sign bit flips the rest)
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The walks keep a running min in each lane and reduce across the warp
// once, when the walk ends: the same set of samples, and min rounds
// nothing, so the order does not matter.

// min of env over (j, p] with j the last index < p where env[j] > h
__device__ float left_base_min(const float* env, const float* bmax,
                               const float* bmin, int p, float h, int nb) {
  const int lane = threadIdx.x & 31;
  float m = INFINITY;
  const int b = p / nb;
  const int bstart = b * nb;
  for (int hi = p - 1; hi >= bstart; hi -= 32) {
    const int i = hi - lane;
    const bool in = i >= bstart;
    const float v = in ? env[i] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && v > h);
    if (gt) {  // the lowest lane holds the highest index above h
      if (lane < __ffs(gt) - 1) m = fminf(m, v);
      return fminf(env[p], warp_min(m));
    }
    m = fminf(m, v);
  }
  for (int bhi = b - 1; bhi >= 0; bhi -= 32) {
    const int bb = bhi - lane;
    const bool in = bb >= 0;
    const float bm = in ? bmin[bb] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && bmax[bb] > h);
    if (!gt) {
      m = fminf(m, bm);
      continue;
    }
    const int first = __ffs(gt) - 1;
    if (lane < first) m = fminf(m, bm);
    const int bp = bhi - first;  // a full block: it lies before block b
    for (int hi = bp * nb + nb - 1; hi >= bp * nb; hi -= 32) {
      const int i = hi - lane;
      const bool in2 = i >= bp * nb;
      const float v = in2 ? env[i] : INFINITY;
      const unsigned g2 = __ballot_sync(kFull, in2 && v > h);
      if (g2) {
        if (lane < __ffs(g2) - 1) m = fminf(m, v);
        break;
      }
      m = fminf(m, v);
    }
    break;  // bmax[bp] > h: the walk ended in block bp
  }
  return fminf(env[p], warp_min(m));
}

// min of env over [p, j) with j the first index > p where env[j] > h
__device__ float right_base_min(const float* env, const float* bmax,
                                const float* bmin, int p, float h, int nb,
                                int T, int B) {
  const int lane = threadIdx.x & 31;
  float m = INFINITY;
  const int b = p / nb;
  const int bend = min(b * nb + nb, T);  // exclusive
  for (int lo = p + 1; lo < bend; lo += 32) {
    const int i = lo + lane;
    const bool in = i < bend;
    const float v = in ? env[i] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && v > h);
    if (gt) {  // the lowest lane holds the lowest index above h
      if (lane < __ffs(gt) - 1) m = fminf(m, v);
      return fminf(env[p], warp_min(m));
    }
    m = fminf(m, v);
  }
  for (int blo = b + 1; blo < B; blo += 32) {
    const int bb = blo + lane;
    const bool in = bb < B;
    const float bm = in ? bmin[bb] : INFINITY;
    const unsigned gt = __ballot_sync(kFull, in && bmax[bb] > h);
    if (!gt) {
      m = fminf(m, bm);
      continue;
    }
    const int first = __ffs(gt) - 1;
    if (lane < first) m = fminf(m, bm);
    const int bn = blo + first;
    const int end = min(bn * nb + nb, T);
    for (int lo = bn * nb; lo < end; lo += 32) {
      const int i = lo + lane;
      const bool in2 = i < end;
      const float v = in2 ? env[i] : INFINITY;
      const unsigned g2 = __ballot_sync(kFull, in2 && v > h);
      if (g2) {
        if (lane < __ffs(g2) - 1) m = fminf(m, v);
        break;
      }
      m = fminf(m, v);
    }
    break;  // bmax[bn] > h: the walk ended in block bn
  }
  return fminf(env[p], warp_min(m));
}

// kMethod: 0 pack, 1 topk. kTimed: thread 0 stamps %globaltimer and
// clock64 at the start and after each phase's closing __syncthreads into
// stamps[row][2][kPhases + 1]; the outputs are the same. kLong: the
// long-row form, its row arrays in `work` (rows x Layout::row_bytes).
template <int kMethod, bool kTimed, bool kLong>
__global__ void __launch_bounds__(kThreads, kMethod == 0 ? 4 : 3)
fused_picks_kernel(const float2* __restrict__ X, const float* __restrict__ thr_in,
                   int32_t* __restrict__ pos_out, float* __restrict__ h_out,
                   float* __restrict__ prom_out, uint8_t* __restrict__ sel_out,
                   uint8_t* __restrict__ sat_out, int T, int K, int nb,
                   unsigned char* work, long long* __restrict__ stamps) {
  const size_t row = blockIdx.x;
  long long* const st = stamps + (kTimed ? row * 2 * (kPhases + 1) : 0);
  auto stamp = [&](int k) {
    if (kTimed && threadIdx.x == 0) {
      st[k] = global_ns();
      st[kPhases + 1 + k] = clock64();
    }
  };
  stamp(0);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(T, K, nb, kMethod, kLong);
  unsigned char* const rowmem = kLong ? work + row * L.row_bytes : smem;
  float* env = reinterpret_cast<float*>(rowmem + L.env);
  float* bmax = reinterpret_cast<float*>(rowmem + L.bmax);
  float* bmin = reinterpret_cast<float*>(rowmem + L.bmin);
  unsigned* bits = reinterpret_cast<unsigned*>(rowmem + L.bits);
  int* slot_pos = reinterpret_cast<int*>(smem + L.slot_pos);
  float* slot_h = reinterpret_cast<float*>(smem + L.slot_h);
  float* slot_prom = reinterpret_cast<float*>(smem + L.slot_prom);
  int* slot_sel = reinterpret_cast<int*>(smem + L.slot_sel);
  int* sel_list = reinterpret_cast<int*>(smem + L.sel_list);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float2* x = X + row * (size_t)T;
  const float thr = thr_in[row];
  const int B = L.B, W = L.W;

  // 1. envelope into shared memory (the only read of X; the workspace
  //    for a long row): a
  //    head sample where the row starts 8 bytes past a 16-byte boundary
  //    (odd row * T), then two samples a float4, then an odd tail sample
  for (int w = tid; w < W; w += kThreads) bits[w] = 0;
  const int head = min((int)((reinterpret_cast<uintptr_t>(x) >> 3) & 1), T);
  const int n4 = (T - head) >> 1;
  if (tid == 0 && head) env[0] = magnitude(x[0].x, x[0].y);
  if (tid == 0 && head + 2 * n4 < T) env[T - 1] = magnitude(x[T - 1].x, x[T - 1].y);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  for (int base = 0; base < n4; base += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = base + u * kThreads + tid;
      v[u] = q < n4 ? __ldcs(x4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = base + u * kThreads + tid;
      if (q < n4) {
        const float a = magnitude(v[u].x, v[u].y), b = magnitude(v[u].z, v[u].w);
        if (head == 0) {
          reinterpret_cast<float2*>(env)[q] = make_float2(a, b);
        } else {
          env[1 + 2 * q] = a;
          env[2 + 2 * q] = b;
        }
      }
    }
  }
  __syncthreads();
  stamp(1);

  // 2. one sweep per block of nb samples: its max/min table entry and the
  //    plateau-exact local maxima as bits. The thread at a strict rise
  //    walks its run; a run that reaches the right edge is no maximum;
  //    the peak is the run's floor-midpoint. A lone peak (the run of one)
  //    joins its group's ballot; a plateau's midpoint may lie in another
  //    word, and is set on its own.
  for (int b = warp; b < B; b += kWarps) {
    if (nb == 128 && b * 128 + 128 <= T) {
      // a full block of 128 at four samples a lane: one float4 of shared
      // memory a lane, the neighbours by shuffles, no branch but a rare
      // one for plateaus; samples 0 and T-1 see an infinite neighbour and
      // are no maximum
      const int i0 = b * 128;
      const float4 v = reinterpret_cast<const float4*>(env + i0)[lane];
      float l = __shfl_up_sync(kFull, v.w, 1);
      float r = __shfl_down_sync(kFull, v.x, 1);
      if (lane == 0) l = i0 > 0 ? env[i0 - 1] : INFINITY;
      if (lane == 31) r = i0 + 128 < T ? env[i0 + 128] : INFINITY;
      const float s[6] = {l, v.x, v.y, v.z, v.w, r};
      unsigned nib = 0;
      bool plateau = false;
#pragma unroll
      for (int k = 1; k <= 4; ++k) {
        const bool rise = s[k - 1] < s[k] && s[k] >= thr;
        nib |= (unsigned)(rise && s[k + 1] < s[k]) << (k - 1);
        plateau |= rise && s[k + 1] == s[k];
      }
      // the four bits of lanes 8w..8w+7 make word w of the block
      unsigned word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      if ((lane & 7) == 0 && word) atomicOr(&bits[(i0 >> 5) + (lane >> 3)], word);
      if (__any_sync(kFull, plateau)) {
#pragma unroll
        for (int k = 1; k <= 4; ++k) {
          if (s[k - 1] < s[k] && s[k] >= thr && s[k + 1] == s[k]) {
            const int i = i0 + 4 * lane + k - 1;
            int j = i + 2;
            while (j < T && env[j] == s[k]) ++j;
            if (j < T && env[j] < s[k]) {
              const int mid = (i + j - 1) >> 1;
              atomicOr(&bits[mid >> 5], 1u << (mid & 31));
            }
          }
        }
      }
      const float mx = warp_max(fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      const float mn = warp_min(fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
      if (lane == 0) {
        bmax[b] = mx;
        bmin[b] = mn;
      }
      continue;
    }
    // any other block: 32 samples a step
    float mx = -INFINITY, mn = INFINITY;
    const int end = min(b * nb + nb, T);
    for (int i0 = b * nb; i0 < end; i0 += 32) {
      const int i = i0 + lane;
      bool peak = false;
      if (i < end) {
        // three independent loads; the edges compare with themselves
        const float v = env[i];
        const float l = env[max(i - 1, 0)];
        const float r = env[min(i + 1, T - 1)];
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
        if (i > 0 && i < T - 1 && l < v && v >= thr) {
          if (r < v) {
            peak = true;
          } else if (r == v) {
            int j = i + 2;
            while (j < T && env[j] == v) ++j;
            if (j < T && env[j] < v) {
              const int mid = (i + j - 1) >> 1;
              atomicOr(&bits[mid >> 5], 1u << (mid & 31));
            }
          }
        }
      }
      const unsigned m = __ballot_sync(kFull, peak);
      if (lane == 0 && m) {
        const int w0 = i0 >> 5, off = i0 & 31;
        atomicOr(&bits[w0], m << off);
        if (off && (m >> (32 - off))) atomicOr(&bits[w0 + 1], m >> (32 - off));
      }
    }
    mx = warp_max(mx);
    mn = warp_min(mn);
    if (lane == 0) {
      bmax[b] = mx;
      bmin[b] = mn;
    }
  }
  __syncthreads();
  stamp(2);

  // 3. candidate ranks: each thread owns a contiguous run of words; a
  //    block scan of their popcounts gives its first candidate's rank in
  //    time order, and the total is the candidate count
  const int wchunk = (W + kThreads - 1) / kThreads;
  const int wlo = min(tid * wchunk, W), whi = min(wlo + wchunk, W);
  int c = 0;
  for (int w = wlo; w < whi; ++w) c += __popc(bits[w]);
  int n_cand;
  const int rank0 = block_excl_scan(c, scratch, &n_cand);
  stamp(3);

  // 4. slots
  const int nS = min(n_cand, K);
  if (kMethod == 0) {  // pack: the candidate of rank s < K to slot s
    if (rank0 < K) {
      int r = rank0;
      for_each_candidate(bits, wlo, whi, [&](int p) {
        if (r < K) {
          slot_pos[r] = p;
          slot_h[r] = env[p];
        }
        ++r;
      });
    }
    for (int s = nS + tid; s < K; s += kThreads) {
      slot_pos[s] = 0;
      slot_h[s] = -INFINITY;
    }
  } else {  // topk: the K tallest, ties toward the lower index
    if (n_cand <= K) {  // all of them, in time order
      int r = rank0;
      for_each_candidate(bits, wlo, whi, [&](int p) { sel_list[r++] = p; });
    } else {
      // radix select of the K-th largest key, 8 bits at a time
      unsigned prefix = 0, mask = 0;
      int k_rem = K;
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
        __syncthreads();
        for_each_candidate(bits, wlo, whi, [&](int p) {
          const unsigned u = order_key(env[p]);
          if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
        });
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
      // first k_rem in index order (threads own words in index order)
      int eq = 0;
      for_each_candidate(bits, wlo, whi,
                         [&](int p) { eq += order_key(env[p]) == prefix; });
      int n_eq;
      const int tie = block_excl_scan(eq, scratch, &n_eq);
      int take = 0;
      {
        int t = tie;
        for_each_candidate(bits, wlo, whi, [&](int p) {
          const unsigned u = order_key(env[p]);
          if (u > prefix) ++take;
          else if (u == prefix) take += (t++ < k_rem);
        });
      }
      int n_take;
      int dst = block_excl_scan(take, scratch, &n_take);
      {
        int t = tie;
        for_each_candidate(bits, wlo, whi, [&](int p) {
          const unsigned u = order_key(env[p]);
          bool in = u > prefix;
          if (u == prefix) in = (t++ < k_rem);
          if (in) sel_list[dst++] = p;
        });
      }
    }
    __syncthreads();
    // top_k order among the kept: height descending, then index ascending
    for (int i = tid; i < nS; i += kThreads) {
      const int p = sel_list[i];
      const unsigned u = order_key(env[p]);
      int r = 0;
      for (int j = 0; j < nS; ++j) {
        const int q = sel_list[j];
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
  stamp(4);

  // 5. exact prominences, one warp per slot; a pack slot past the
  //    candidates takes no walk: its h is -inf and its bases are env[0]
  const int n_walk = kMethod == 0 ? nS : K;
  for (int s = warp; s < n_walk; s += kWarps) {
    const int p = slot_pos[s];
    const float h = slot_h[s];
    const float lmin = left_base_min(env, bmax, bmin, p, h, nb);
    const float rmin = right_base_min(env, bmax, bmin, p, h, nb, T, B);
    if (lane == 0) {
      const float prom = __fsub_rn(h, fmaxf(lmin, rmin));
      const bool valid = kMethod == 0 || isfinite(h);
      slot_prom[s] = prom;
      slot_sel[s] = valid && prom >= thr;
    }
  }
  for (int s = n_walk + tid; s < K; s += kThreads) {
    slot_prom[s] = __fsub_rn(-INFINITY, env[0]);
    slot_sel[s] = 0;
  }
  __syncthreads();
  stamp(5);

  // 6. outputs: pack keeps slot order; topk orders the slots by
  //    (selected ? position : T), stable in slot order
  const size_t base = row * (size_t)K;
  for (int s = tid; s < K; s += kThreads) {
    const bool sel = slot_sel[s] != 0;
    int dst = s;
    if (kMethod != 0) {
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
  if (kTimed) {
    __syncthreads();
    stamp(6);
  }
}

// Opts the instantiation in to `bytes` of dynamic shared memory on the
// current device, once a device for the largest size asked there so far
// (function attributes are per device). Callers on several threads may set
// the same attributes twice, which is harmless; the record only grows.
template <int kMethod, bool kTimed, bool kLong>
cudaError_t prepare(size_t bytes) {
  static std::atomic<size_t> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && bytes <= granted[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_picks_kernel<kMethod, kTimed, kLong>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: four CTAs need 4 x
  // 52 KB of it, more than the carveout CUDA may choose by itself
  err = cudaFuncSetAttribute(fused_picks_kernel<kMethod, kTimed, kLong>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || !kept) return err;
  size_t g = granted[dev].load(std::memory_order_acquire);
  while (g < bytes && !granted[dev].compare_exchange_weak(g, bytes)) {
  }
  return cudaSuccess;
}

template <int kMethod, bool kTimed, bool kLong>
int launch(const void* X, const void* thr, void* pos, void* heights, void* prom,
           void* sel, void* sat, void* work, int rows, int T, int K, int nb,
           void* stamps, void* stream) {
  const size_t bytes = make_layout(T, K, nb, kMethod, kLong).bytes;
  const cudaError_t err = prepare<kMethod, kTimed, kLong>(bytes);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  fused_picks_kernel<kMethod, kTimed, kLong>
      <<<rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float2*>(X), static_cast<const float*>(thr),
          static_cast<int32_t*>(pos), static_cast<float*>(heights),
          static_cast<float*>(prom), static_cast<uint8_t*>(sel),
          static_cast<uint8_t*>(sat), T, K, nb, static_cast<unsigned char*>(work),
          static_cast<long long*>(stamps));
  return (int)cudaGetLastError();
}

// `work` null: the shared-memory form; else the long-row form
template <bool kTimed>
int launch_method(const void* X, const void* thr, void* pos, void* heights,
                  void* prom, void* sel, void* sat, void* work, int rows, int T,
                  int K, int method, int nb, void* stamps, void* stream) {
  if (method == 0 && !work)
    return launch<0, kTimed, false>(X, thr, pos, heights, prom, sel, sat, work,
                                    rows, T, K, nb, stamps, stream);
  if (method == 0)
    return launch<0, kTimed, true>(X, thr, pos, heights, prom, sel, sat, work,
                                   rows, T, K, nb, stamps, stream);
  if (method == 1 && !work)
    return launch<1, kTimed, false>(X, thr, pos, heights, prom, sel, sat, work,
                                    rows, T, K, nb, stamps, stream);
  if (method == 1)
    return launch<1, kTimed, true>(X, thr, pos, heights, prom, sel, sat, work,
                                   rows, T, K, nb, stamps, stream);
  return (int)cudaErrorInvalidValue;
}

template <int kMethod, bool kLong>
int ctas_per_sm(int T, int K, int nb) {
  const size_t bytes = make_layout(T, K, nb, kMethod, kLong).bytes;
  int n = -1;
  cudaError_t err = prepare<kMethod, false, kLong>(bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fused_picks_kernel<kMethod, false, kLong>, kThreads, bytes);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" {

// dynamic shared memory one CTA of `method` needs for a row of T samples
// at K slots: the layout its launch uses (`long_row`: the long-row form's)
long long fused_picks_smem_bytes(int T, int K, int method, int nb, int long_row) {
  return (long long)make_layout(T, K, nb, method, long_row != 0).bytes;
}

// the long-row form's workspace a row, in bytes (a multiple of 16)
long long fused_picks_row_bytes(int T, int K, int method, int nb) {
  return (long long)make_layout(T, K, nb, method, true).row_bytes;
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

// CTAs of the untimed kernel that fit on one SM at once for this shape
// (registers, threads and shared memory), or -1 on error
int fused_picks_ctas_per_sm(int T, int K, int method, int nb, int long_row) {
  if (method == 0)
    return long_row ? ctas_per_sm<0, true>(T, K, nb) : ctas_per_sm<0, false>(T, K, nb);
  if (method == 1)
    return long_row ? ctas_per_sm<1, true>(T, K, nb) : ctas_per_sm<1, false>(T, K, nb);
  return -1;
}

// Launch on `stream`; returns cudaGetLastError() after the launch. `work`
// null launches the shared-memory form; else the long-row form, with
// `work` rows x fused_picks_row_bytes() bytes of device memory.
int fused_picks_launch(const void* X, const void* thr, void* pos, void* heights,
                       void* prom, void* sel, void* sat, void* work, int rows,
                       int T, int K, int method, int nb, void* stream) {
  return launch_method<false>(X, thr, pos, heights, prom, sel, sat, work, rows,
                              T, K, method, nb, nullptr, stream);
}

// The phase-timed instantiation: the same outputs, and `stamps`
// [rows, 2, kPhases + 1] int64 (%globaltimer ns, then clock64 cycles).
int fused_picks_launch_timed(const void* X, const void* thr, void* pos,
                             void* heights, void* prom, void* sel, void* sat,
                             void* work, int rows, int T, int K, int method,
                             int nb, void* stamps, void* stream) {
  return launch_method<true>(X, thr, pos, heights, prom, sel, sat, work, rows,
                             T, K, method, nb, stamps, stream);
}

}  // extern "C"

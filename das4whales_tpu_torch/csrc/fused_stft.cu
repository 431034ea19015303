// |STFT|^2 kernel for Hopper (sm_90a): the windowed real DFT of every
// frame, folded by its two symmetries, on the CUDA cores, with the power
// fused before the write.
//
// Replaces the TPU kernel `_stft_kernel` of
// das4whales_tpu/ops/pallas_stft.py (launched by its `pl.pallas_call`).
// It computes the same function,
//
//   out[c, f, j] = (sum_n s[n] * M[n, f])^2 + (sum_n s[n] * M[n, F + f])^2,
//   s[n] = xt[c, j*hop + n],  n = 0 .. N-1,  N = nfft,
//
// where M [N, 2F] is the windowed real-DFT matrix (cos | sin halves,
// F = N/2 + 1) that the wrapper passes in, and xt is x shifted right by
// `offset` samples (N/2 when centred, else 0) and zero outside [0, T).
// It does not carry the Pallas block layout over: the (8, 128) span
// blocks and swapaxes exist for Mosaic's tiling.
//
// The fold. Both windows the JAX kernel offers (periodic Hann, ones) are
// symmetric, w[N-n] = w[n], so C = M[:, :F] and S = M[:, F:] satisfy
// C[N-n, k] = C[n, k] and S[N-n, k] = -S[n, k]. With u[n] = s[n] + s[N-n]
// and v[n] = s[n] - s[N-n] for 1 <= n < N/2 (u[0] = s[0], v[0] = 0, and
// for even N u[N/2] = s[N/2], v[N/2] = 0), re[k] = sum_{n <= N/2} u C and
// im[k] = sum_{n <= N/2} v S: half the taps. For even N, moreover,
// C[n, N/2-k] = (-1)^n C[n, k] and S[n, N/2-k] = -(-1)^n S[n, k], so with
// the sums split by the parity of n (Er, Or over u C; Ei, Oi over v S),
//
//   P[k] = (Er + Or)^2 + (Ei + Oi)^2,  P[N/2 - k] = (Er - Or)^2 + (Ei - Oi)^2,
//
// for k = 0 .. N/4 (the bin k = N/4 pairs with itself when 4 | N and is
// written once): half the frequencies. Odd N takes the first fold only,
// every k < F. The kernel reads only rows n <= N/2 and columns k <= N/4
// (odd N: k < F) of M. Each side of both folds is rounded in float32 as
// the plain version rounds its sums; the two agree to tolerance, not bit
// for bit.
//
// Bound. At the main path's launch (C = 4096 channels, T = 12000,
// N = 160, hop = 8: F = 81, n_frames = 1501) the function moves 0.20 GB
// read and 1.99 GB written, 0.653 ms at the H100's 3.35 TB/s; as an FFT
// of each frame it needs 2.0e10 operations, 0.31 ms at 67 TFLOP/s
// float32: the bytes bound it. The dense contraction of the earlier
// design did 160 * 162 multiply-adds a frame, 3.19e11 operations, a
// 4.76 ms floor of its own. Folded, a frame takes 81 taps * 41 k *
// (re, im) = 6642 multiply-adds plus the folds, the pairing and the
// power: 8.5e10 operations at the main launch, a floor of 1.27 ms,
// within 2x of the byte bound. The design stays on the CUDA cores: plain
// TF32 on the tensor cores keeps a 10-bit mantissa and cannot meet the
// kernel's 5e-6 * max contract, and after the fold the operations could
// gain at most that factor of 2 over the bytes.
//
// * one CTA per (channel, tile of TJ = 32*R frames). With the span its
//   frames cover, (TJ - 1)*hop + N samples, in shared memory in polyphase
//   order, ph[p][m] = xt[j0*hop + m*hop + p] (out-of-range samples read
//   as zero, which is the centring: no padded copy of x is made), the CTA
//   folds a chunk of taps n into u[n][jj] and v[n][jj] for its frames jj,
//   reading s[n] and s[N-n] of 32 consecutive frames as 32 consecutive
//   words (no bank conflicts for any hop) at offsets from a table made
//   once per CTA. Where the span does not fit in 48 KB even at R = 1 (a
//   large hop or N, e.g. N = hop = 2048), it folds straight from x;
// * the chunk is all N/2 taps where that fits in 112 KB of shared memory
//   (N = 160, R = 4: 102,640 bytes, the launch opting in with
//   cudaFuncSetAttribute; two CTAs an SM), folded once for every pass
//   over the k groups; else 32 taps (at most 48 KB), folded per pass;
// * each warp owns groups of kQ = 4 consecutive k; a thread accumulates
//   Er, Or, Ei, Oi of its R frames (lane + 32*r) x 4 k with FMA: per tap
//   R loads of u, R of v, two broadcast float4 loads of C and S, 8*R FMAs.
//   Taps are taken in pairs (odd, even), so the parity picks the E or O
//   accumulators with no branch. R = 4 x kQ = 4 x 4 = 64 accumulators;
//   tap 0, whose mirror N lies outside the frame, starts Er as
//   s[0] * C[0, k] (S[0, k] = sin 0 = 0);
// * M passes through shared memory a chunk of taps at a time, only the
//   columns of the k groups the CTA's warps work on in that pass;
// * the power is written with frames innermost, so a warp's stores are
//   contiguous in [C, F, n_frames], for the bin k and for its pair N/2-k.
//
// On the H100 (chip_smoke.py prints the -Xptxas -v report) the main
// launch's instantiation, R = 4 with the span staged, takes 127 registers
// and spills nothing: two CTAs of 6 warps an SM, by registers and by
// shared memory alike. What holds it back is shared-memory bandwidth: a
// warp reads 16 words of u and v and two broadcast float4 of M for 32
// FMAs a tap (PERF.md).
//
// FMA contraction stays on for this file: the kernel is compared with its
// plain version by tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 4;         // k values per thread: one float4 of M
constexpr int kMaxR = 4;      // frames per thread: 32*kMaxR frames a CTA
constexpr int kTaps = 32;     // taps per chunk where all N/2 do not fit
constexpr int kMaxWarps = 8;

constexpr size_t kSmemBudget = 48 * 1024;        // a launch without an opt-in
constexpr size_t kOneChunkBudget = 112 * 1024;   // all taps in one chunk: two CTAs an SM

struct Plan {
  int F, K2, n_frames, R, W, groups, MP, n_tiles, ct;
  bool span;  // the whole span in shared memory, else a fold straight from x
  size_t smem;
};

inline int frames_of(int T, int nfft, int hop, int center) {
  return center ? 1 + T / hop : 1 + (T - nfft) / hop;
}

// M chunk [ct][2][kQ W], u and v [ct][32R], and with the span its
// offset table [N/2 + 1, even] and the span itself [hop][MP]
inline size_t smem_bytes(int R, int W, int nfft, int hop, bool span, int ct) {
  const size_t sp = span ? (size_t)hop * (32 * R + (nfft - 1) / hop) + 2 * ((nfft / 2 + 2) & ~1) : 0;
  return sizeof(float) * ((size_t)ct * 2 * kQ * W + 2 * (size_t)ct * 32 * R + sp);
}

// The k computed directly, K2 (N/4 + 1 for even N, F for odd N), in
// groups of kQ; frames per thread R (a tile of 32*R frames), warps per
// CTA W and taps per chunk ct. R: the smallest power of two up to kMaxR
// whose tile covers the frames; with the span staged, halved while 32-tap
// chunks pass 48 KB, and where even R = 1 passes it, the fold straight
// from x at the first R. W: the count in [4, 8] (or all groups, when
// fewer) that wastes the fewest warp slots over the groups, the larger on
// a tie. ct: all N/2 taps where they fit in kOneChunkBudget, else kTaps.
inline Plan make_plan(int T, int nfft, int hop, int center) {
  Plan P;
  P.F = nfft / 2 + 1;
  P.K2 = nfft % 2 == 0 ? nfft / 4 + 1 : P.F;
  P.n_frames = frames_of(T, nfft, hop, center);
  P.groups = (P.K2 + kQ - 1) / kQ;
  const int wmax = P.groups < kMaxWarps ? P.groups : kMaxWarps;
  const int wmin = P.groups < 4 ? P.groups : 4;
  P.W = wmax;
  int best = 1 << 30;
  for (int w = wmax; w >= wmin; --w) {
    const int waste = (P.groups + w - 1) / w * w - P.groups;
    if (waste < best) {
      best = waste;
      P.W = w;
    }
  }
  P.R = 1;
  while (P.R < kMaxR && 32 * P.R < P.n_frames) P.R *= 2;
  P.span = smem_bytes(1, P.W, nfft, hop, true, kTaps) <= kSmemBudget;
  while (P.span && P.R > 1 && smem_bytes(P.R, P.W, nfft, hop, true, kTaps) > kSmemBudget) P.R /= 2;
  const int H = nfft / 2;
  P.ct = H > kTaps && smem_bytes(P.R, P.W, nfft, hop, P.span, H) <= kOneChunkBudget ? H : kTaps;
  P.MP = 32 * P.R + (nfft - 1) / hop;
  P.n_tiles = (P.n_frames + 32 * P.R - 1) / (32 * P.R);
  P.smem = smem_bytes(P.R, P.W, nfft, hop, P.span, P.ct);
  return P;
}

template <int R, bool kSpan>
__global__ void __launch_bounds__(32 * kMaxWarps)
    fused_stft_kernel(const float* __restrict__ x, const float* __restrict__ M,
                      float* __restrict__ out, int T, int nfft, int hop, int F, int K2,
                      int n_frames, int offset, int MP, int n_tiles, int groups, int ct) {
  extern __shared__ float4 smem4[];
  constexpr int TJ = 32 * R;
  const int W = blockDim.x >> 5;
  const int GW = W * kQ;                          // k values per pass
  const int H = nfft / 2;                         // the last tap folded (odd N: (N-1)/2)
  float* ms = reinterpret_cast<float*>(smem4);    // [ct][2][GW]
  float* us = ms + ct * 2 * GW;                   // [ct][TJ]
  float* vs = us + ct * TJ;                       // [ct][TJ]
  int2* offs = reinterpret_cast<int2*>(vs + ct * TJ);                         // kSpan: [H + 1]
  float* xs = reinterpret_cast<float*>(offs + (kSpan ? ((H + 2) & ~1) : 0));  // kSpan: [hop][MP]
  const int tile = blockIdx.x % n_tiles;
  const int c = blockIdx.x / n_tiles;
  const int j0 = tile * TJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xc = x + (size_t)c * T;

  // the tile's span of xt in polyphase order, and where s[n] and s[N-n]
  // of frame 0 lie in it
  const long long s0 = (long long)j0 * hop - offset;
  if (kSpan) {
    for (int s = tid; s < hop * MP; s += blockDim.x) {
      const long long src = s0 + s;
      const float v = (src >= 0 && src < T) ? __ldg(xc + src) : 0.f;
      xs[(s % hop) * MP + s / hop] = v;
    }
    for (int n = tid; n <= H; n += blockDim.x) {
      const int m = nfft - n;
      offs[n] = make_int2((n % hop) * MP + n / hop, (m % hop) * MP + m / hop);
    }
  }
  // tap 0 of this thread's frames
  float x0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long src = s0 + (long long)(lane + 32 * r) * hop;
    x0[r] = (src >= 0 && src < T) ? __ldg(xc + src) : 0.f;
  }

  // this thread's column of an M chunk: blockDim = 32W = 4 * (2 * GW)
  const int col = tid % (2 * GW);
  const int row0 = tid / (2 * GW);
  const int half = col / GW;
  const int lcol = col % GW;

  float* oc = out + (size_t)c * F * n_frames;
  const int n_pass = (groups + W - 1) / W;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int g = pass * W + warp;              // this warp's group
    const int k_load = pass * GW + lcol;        // the column this thread loads
    float er[R][kQ], eo[R][kQ], ie[R][kQ], io[R][kQ];  // Er, Or, Ei, Oi
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = g * kQ + q;
      const float c0 = (g < groups && k < K2) ? __ldg(M + k) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        er[r][q] = x0[r] * c0;
        eo[r][q] = ie[r][q] = io[r][q] = 0.f;
      }
    }

    for (int n0 = 1; n0 <= H; n0 += ct) {
      const int kc = H + 1 - n0 < ct ? H + 1 - n0 : ct;
      __syncthreads();  // the previous chunk is consumed; the span is written
      for (int kk = row0; kk < kc; kk += 4)
        ms[kk * 2 * GW + col] =
            k_load < K2 ? __ldg(M + (size_t)(n0 + kk) * 2 * F + half * F + k_load) : 0.f;
      // fold the chunk's taps: a single chunk is folded once, for every pass
      for (int kk = (pass > 0 && ct >= H) ? kc : warp; kk < kc; kk += W) {
        const int n = n0 + kk;
        const bool mid = 2 * n == nfft;         // the middle tap is its own mirror
        int2 o;
        if (kSpan) o = offs[n];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int jj = lane + 32 * r;
          float a, b;
          if (kSpan) {
            a = xs[o.x + jj];
            b = xs[o.y + jj];
          } else {
            const long long base = s0 + (long long)jj * hop;
            const long long ia = base + n, ib = base + nfft - n;
            a = (ia >= 0 && ia < T) ? __ldg(xc + ia) : 0.f;
            b = (ib >= 0 && ib < T) ? __ldg(xc + ib) : 0.f;
          }
          us[kk * TJ + jj] = mid ? a : a + b;
          vs[kk * TJ + jj] = mid ? 0.f : a - b;
        }
      }
      __syncthreads();
      if (g < groups) {
        const float* up = us + lane;
        const float* vp = vs + lane;
        const float* mp = ms + warp * kQ;
        auto tap = [&](int kk, float (&re)[R][kQ], float (&im)[R][kQ]) {
          const float4 mc = *reinterpret_cast<const float4*>(mp + kk * 2 * GW);
          const float4 mv = *reinterpret_cast<const float4*>(mp + kk * 2 * GW + GW);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float u = up[kk * TJ + 32 * r], v = vp[kk * TJ + 32 * r];
            re[r][0] = fmaf(u, mc.x, re[r][0]);
            re[r][1] = fmaf(u, mc.y, re[r][1]);
            re[r][2] = fmaf(u, mc.z, re[r][2]);
            re[r][3] = fmaf(u, mc.w, re[r][3]);
            im[r][0] = fmaf(v, mv.x, im[r][0]);
            im[r][1] = fmaf(v, mv.y, im[r][1]);
            im[r][2] = fmaf(v, mv.z, im[r][2]);
            im[r][3] = fmaf(v, mv.w, im[r][3]);
          }
        };
        // n0 is odd (1 + a multiple of ct, which is even or spans all
        // taps): even kk is an odd tap
        int kk = 0;
        for (; kk + 1 < kc; kk += 2) {
          tap(kk, eo, io);
          tap(kk + 1, er, ie);
        }
        if (kk < kc) tap(kk, eo, io);
      }
    }
    if (g < groups) {
      const bool pair = nfft % 2 == 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + lane + 32 * r;
        if (j >= n_frames) continue;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int k = g * kQ + q;
          if (k >= K2) continue;
          const float re1 = er[r][q] + eo[r][q], im1 = ie[r][q] + io[r][q];
          oc[(size_t)k * n_frames + j] = re1 * re1 + im1 * im1;
          if (pair && H - k != k) {
            const float re2 = er[r][q] - eo[r][q], im2 = ie[r][q] - io[r][q];
            oc[(size_t)(H - k) * n_frames + j] = re2 * re2 + im2 * im2;
          }
        }
      }
    }
  }
}

template <int R>
int launch(const Plan& P, const float* x, const float* M, float* out, int C, int T,
           int nfft, int hop, int offset, cudaStream_t stream) {
  const long long blocks = (long long)C * P.n_tiles;
  auto kernel = P.span ? fused_stft_kernel<R, true> : fused_stft_kernel<R, false>;
  if (P.smem > kSmemBudget) {  // the one-chunk plan opts in past 48 KB
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, 32 * P.W, P.smem, stream>>>(
      x, M, out, T, nfft, hop, P.F, P.K2, P.n_frames, offset, P.MP, P.n_tiles, P.groups, P.ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_stft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [C, T] float32, M [nfft, 2F] float32, out [C, F, n_frames] float32, all
// contiguous on the device. Launches on `stream`; returns cudaGetLastError()
// after the launch (0 when there is nothing to launch).
int fused_stft_launch(const void* x, const void* M, void* out, int C, int T, int nfft,
                      int hop, int center, void* stream) {
  if (C == 0) return 0;
  const Plan P = make_plan(T, nfft, hop, center);
  const int offset = center ? nfft / 2 : 0;
  const float* xf = static_cast<const float*>(x);
  const float* Mf = static_cast<const float*>(M);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P.R) {
    case 4: return launch<4>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
    case 2: return launch<2>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
    default: return launch<1>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
  }
}

}  // extern "C"

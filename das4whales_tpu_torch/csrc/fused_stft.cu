// |STFT|^2 kernel for Hopper (sm_90a): the windowed real DFT of every
// frame as a framed contraction, with the power fused before the write.
//
// Replaces the TPU kernel `_stft_kernel` of
// das4whales_tpu/ops/pallas_stft.py (launched by its `pl.pallas_call`).
// It computes the same function,
//
//   out[c, f, j] = (sum_k xt[c, j*hop + k] * M[k, f])^2
//                + (sum_k xt[c, j*hop + k] * M[k, F + f])^2,
//
// where M [nfft, 2F] is the windowed real-DFT matrix (cos | sin halves,
// F = nfft/2 + 1) that the wrapper passes in, and xt is x shifted right by
// `offset` samples (nfft/2 when centred, else 0) and zero outside
// [0, T). It does not carry the Pallas block layout over: the (8, 128)
// span blocks and swapaxes exist for Mosaic's tiling.
//
// Bound. At the main path's launch (C = 4096 channels, T = 12000,
// nfft = 160, hop = 8: F = 81, n_frames = 1501) the function moves
// 0.20 GB read and 1.99 GB written, 0.65 ms at the H100's 3.35 TB/s. Its
// operations, computed as an FFT of each frame (window, a real FFT of
// about 2.5 * nfft * log2(nfft) operations, the power), are 2.0e10,
// 0.31 ms at 67 TFLOP/s float32 on the CUDA cores: the function is bound
// by bytes. This design computes the DFT as a contraction instead,
// 4096 * 1501 * 160 * 162 * 2 = 3.19e11 operations, 4.76 ms: that is its
// own floor, 7x the function's. It keeps every operand of the
// contraction on chip and spends its issue slots on FMAs:
//
// * one CTA per (channel, tile of TJ = 32*R frames); the span its frames
//   cover, (TJ - 1)*hop + nfft samples, is loaded once into shared memory
//   in polyphase order, ph[p][m] = xt[j0*hop + m*hop + p], so that the 32
//   lanes of a warp (32 consecutive frames) read 32 consecutive words for
//   any tap: no bank conflicts. Out-of-range samples read as zero, which
//   is the centring: no padded copy of x is made;
// * each warp owns groups of kQ = 4 consecutive frequencies; a thread
//   accumulates re and im of its R frames (lane + 32*r) x 4 frequencies in
//   float32 registers with FMA: per tap R loads of x, two broadcast float4
//   loads of M, 8*R FMAs;
// * M passes through shared memory in chunks of kTaps taps, only the
//   columns of the frequency groups the CTA's warps work on in that pass;
// * where the span does not fit in 48 KB even at R = 1 (a large hop or
//   nfft, e.g. nfft = hop = 2048), the CTA instead gathers, with each
//   chunk of M, the kTaps samples of each of its frames that the chunk
//   needs, xs[kk][jj] = xt[(j0 + jj)*hop + k0 + kk]: at most 40 KB for
//   any shape, at the cost of reloading the samples for every chunk;
// * the power re*re + im*im is written with frames innermost, so a warp's
//   stores are contiguous in [C, F, n_frames].
//
// FMA contraction stays on for this file: the kernel is compared with its
// plain version by tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 4;         // frequencies per thread: one float4 of M
constexpr int kTaps = 32;     // taps per chunk of M in shared memory
constexpr int kMaxWarps = 8;

constexpr size_t kSmemBudget = 48 * 1024;

struct Plan {
  int F, n_frames, R, W, groups, MP, n_tiles;
  bool span;  // the whole span in shared memory, else a gather per chunk
  size_t smem;
};

inline int frames_of(int T, int nfft, int hop, int center) {
  return center ? 1 + T / hop : 1 + (T - nfft) / hop;
}

inline size_t smem_bytes(int R, int W, int nfft, int hop, bool span) {
  const size_t xs = span ? (size_t)hop * (32 * R + (nfft - 1) / hop) : (size_t)kTaps * 32 * R;
  return sizeof(float) * ((size_t)kTaps * 2 * kQ * W + xs);
}

// Frames per thread R (a tile of 32*R frames) and warps per CTA W.
// R: the smallest power of two up to 8 whose tile covers the frames;
// with the whole span staged, halved while the CTA's shared memory passes
// 48 KB, and where even R = 1 passes it, the per-chunk gather at the
// first R (40 KB at most). W: the count in [4, 8] (or all groups, when
// fewer) that wastes the fewest warp slots over the frequency groups,
// the larger on a tie.
inline Plan make_plan(int T, int nfft, int hop, int center) {
  Plan P;
  P.F = nfft / 2 + 1;
  P.n_frames = frames_of(T, nfft, hop, center);
  P.groups = (P.F + kQ - 1) / kQ;
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
  while (P.R < 8 && 32 * P.R < P.n_frames) P.R *= 2;
  P.span = smem_bytes(1, P.W, nfft, hop, true) <= kSmemBudget;
  while (P.span && P.R > 1 && smem_bytes(P.R, P.W, nfft, hop, true) > kSmemBudget) P.R /= 2;
  P.MP = 32 * P.R + (nfft - 1) / hop;
  P.n_tiles = (P.n_frames + 32 * P.R - 1) / (32 * P.R);
  P.smem = smem_bytes(P.R, P.W, nfft, hop, P.span);
  return P;
}

template <int R, bool kSpan>
__global__ void __launch_bounds__(32 * kMaxWarps)
    fused_stft_kernel(const float* __restrict__ x, const float* __restrict__ M,
                      float* __restrict__ out, int T, int nfft, int hop, int F,
                      int n_frames, int offset, int MP, int n_tiles, int groups) {
  extern __shared__ float4 smem4[];
  const int W = blockDim.x >> 5;
  const int GW = W * kQ;                  // frequencies per pass
  float* ms = reinterpret_cast<float*>(smem4);   // [kTaps][2][GW]
  float* xs = ms + kTaps * 2 * GW;  // kSpan: [hop][MP], else [kTaps][32R]
  const int tile = blockIdx.x % n_tiles;
  const int c = blockIdx.x / n_tiles;
  const int j0 = tile * 32 * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xc = x + (size_t)c * T;

  // the tile's span of xt, in polyphase order
  const long long s0 = (long long)j0 * hop - offset;
  if (kSpan) {
    for (int s = tid; s < hop * MP; s += blockDim.x) {
      const long long src = s0 + s;
      const float v = (src >= 0 && src < T) ? __ldg(xc + src) : 0.f;
      xs[(s % hop) * MP + s / hop] = v;
    }
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
    const int f_load = pass * GW + lcol;        // the column this thread loads
    float re[R][kQ], im[R][kQ];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < kQ; ++q) re[r][q] = im[r][q] = 0.f;

    for (int k0 = 0; k0 < nfft; k0 += kTaps) {
      const int kc = nfft - k0 < kTaps ? nfft - k0 : kTaps;
      __syncthreads();  // the previous chunk is consumed; the span is written
      for (int kk = row0; kk < kTaps; kk += 4) {
        const int k = k0 + kk;
        ms[kk * 2 * GW + col] = (kk < kc && f_load < F)
                                    ? __ldg(M + (size_t)k * 2 * F + half * F + f_load)
                                    : 0.f;
      }
      if (!kSpan) {  // the chunk's taps of each frame of the tile
        for (int s = tid; s < kTaps * 32 * R; s += blockDim.x) {
          const long long src = s0 + (long long)(s % (32 * R)) * hop + k0 + s / (32 * R);
          xs[s] = (src >= 0 && src < T) ? __ldg(xc + src) : 0.f;
        }
      }
      __syncthreads();
      if (g < groups) {
        int p = k0 % hop, q = k0 / hop;
        const float* mrow = ms + warp * kQ;
#pragma unroll 2
        for (int kk = 0; kk < kc; ++kk) {
          const float* xp = kSpan ? xs + p * MP + q + lane : xs + kk * 32 * R + lane;
          float xv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) xv[r] = xp[32 * r];
          const float4 mr = *reinterpret_cast<const float4*>(mrow + kk * 2 * GW);
          const float4 mi = *reinterpret_cast<const float4*>(mrow + kk * 2 * GW + GW);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            re[r][0] = fmaf(xv[r], mr.x, re[r][0]);
            re[r][1] = fmaf(xv[r], mr.y, re[r][1]);
            re[r][2] = fmaf(xv[r], mr.z, re[r][2]);
            re[r][3] = fmaf(xv[r], mr.w, re[r][3]);
            im[r][0] = fmaf(xv[r], mi.x, im[r][0]);
            im[r][1] = fmaf(xv[r], mi.y, im[r][1]);
            im[r][2] = fmaf(xv[r], mi.z, im[r][2]);
            im[r][3] = fmaf(xv[r], mi.w, im[r][3]);
          }
          if (++p == hop) {
            p = 0;
            ++q;
          }
        }
      }
    }
    if (g < groups) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + lane + 32 * r;
        if (j >= n_frames) continue;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int f = g * kQ + q;
          if (f < F) oc[(size_t)f * n_frames + j] = re[r][q] * re[r][q] + im[r][q] * im[r][q];
        }
      }
    }
  }
}

template <int R>
int launch(const Plan& P, const float* x, const float* M, float* out, int C, int T,
           int nfft, int hop, int offset, cudaStream_t stream) {
  // P.smem stays within the 48 KB a launch takes without an opt-in
  const long long blocks = (long long)C * P.n_tiles;
  if (P.span)
    fused_stft_kernel<R, true><<<(unsigned)blocks, 32 * P.W, P.smem, stream>>>(
        x, M, out, T, nfft, hop, P.F, P.n_frames, offset, P.MP, P.n_tiles, P.groups);
  else
    fused_stft_kernel<R, false><<<(unsigned)blocks, 32 * P.W, P.smem, stream>>>(
        x, M, out, T, nfft, hop, P.F, P.n_frames, offset, P.MP, P.n_tiles, P.groups);
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
    case 8: return launch<8>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
    case 4: return launch<4>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
    case 2: return launch<2>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
    default: return launch<1>(P, xf, Mf, of, C, T, nfft, hop, offset, s);
  }
}

}  // extern "C"

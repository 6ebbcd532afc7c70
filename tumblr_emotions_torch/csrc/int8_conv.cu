// Hopper (sm_90a) int8 convolution for the int8 serving engine.
//
// Replaces tumblr_emotions_tpu/ops/pallas_conv.py::valid_conv3x3_int8_shift
// (the Pallas plane-shift VALID 3x3 int8 conv with the integer shift
// epilogue), widened to every conv that tumblr_emotions_tpu/ops/quant.py::
// _tower issues through _conv_raw + _Int8Ops._apply_epilogue: 1x1 (single
// and packed), 3x3 SAME/VALID, 5x5 SAME, 1x3/3x1/1x7/7x1 SAME, 3x3 stride-2
// VALID, the 2x2 space-to-depth stem (Cin 12) and the 3x3/2 stem on Cin 3.
//
// conv_int8: implicit GEMM, M = B*Ho*Wo output pixels, N = Cout, K =
//   kh*kw*Cin (tap-major, then channel; the weights are [Cout][K], so each
//   output channel's K run is contiguous, the "col" operand of the MMA).
//   int8 tensor-core MMA (mma.sync m16n8k32 s8.s8 -> s32), int32 accumulator.
//   Out-of-image taps read zero (SAME padding).  Epilogue per output-channel
//   segment (at most 4 segments, each with its own output tensor, pixel
//   stride and kind), so a packed 1x1 conv is one launch:
//     SHIFT   clamp((acc + b_i) >> k, 0, 127) -> int8 (wrapping int32 add,
//             arithmetic shift: bit-exact with the reference)
//     F32     clip(float(acc) * m + bq, 0, 127) -> int8 by truncation
//     DEQUANT max(float(acc) * m + b, 0) -> bf16 (round to nearest even)
//     PRE     acc -> int32
//   The float steps use __fmul_rn/__fadd_rn so nvcc cannot contract them
//   into an FMA that the reference does not do.
//   What bounds it: at B=64 the engine's convs do 2*K int ops per output
//   byte, e.g. Conv2d_4a 89 GOP against 38 MB (2,300 ops per byte), above
//   the H100's 1,979 TOP/s / 3.35 TB/s = 590 ops per byte: the tensor cores
//   are the limit wherever K is large; the 1x1s at 8x8 and the stem are
//   nearer the memory bound.  The design: 64x64 output tiles, 4 warps of
//   32x32, K in steps of 64 bytes; the next step's global loads are issued
//   into registers before the current step's MMAs.  16-byte loads when Cin,
//   the input pixel stride and the pointers are multiples of 16; 4-byte
//   words when they are multiples of 4 (the Cin 12 space-to-depth stem);
//   otherwise bytes (the Cin 3 stem).  The K tail is zero-filled.
//   (wgmma, TMA and a shared-memory ring are later work.)
//
// The extern "C" entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output pixels per tile
constexpr int BN = 64;       // output channels per tile
constexpr int BK = 64;       // K bytes per step
constexpr int PAD = 16;      // shared row padding: 80-byte rows, conflict-free fragment reads
constexpr int THREADS = 128;
constexpr int MAX_SEGS = 4;

enum Kind { SHIFT = 0, F32 = 1, DEQUANT = 2, PRE = 3 };

struct Segs {
  int n;
  int end[MAX_SEGS];            // exclusive end channel of each segment
  int kind[MAX_SEGS];
  long long stride[MAX_SEGS];   // output pixel stride, in elements
  void* out[MAX_SEGS];
};

struct Geom {
  int B, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, ph, pw;
  long long x_stride;           // input pixel stride, in bytes
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int G>  // global load granularity in bytes: 16, 4 or 1
__global__ void __launch_bounds__(THREADS)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Geom g,
                 const int* __restrict__ bias_i, const int* __restrict__ shift,
                 const float* __restrict__ mul, const float* __restrict__ add, Segs segs) {
  __shared__ __align__(16) int8_t As[BM][BK + PAD];  // [pixel][k]
  __shared__ __align__(16) int8_t Bs[BN][BK + PAD];  // [cout][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;        // mma fragment coordinates
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long M = (long long)g.B * g.Ho * g.Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = g.kh * g.kw * g.Cin;

  // Each thread copies one 16-byte K chunk of rows `row` and `row + 32`,
  // for the A (pixel) tile and the B (output channel) tile alike.
  const int chunk = tid & 3, row = tid >> 2;
  int iy0[2], ix0[2];
  long long img[2];
  bool pvalid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long p = m0 + row + 32 * j;
    pvalid[j] = p < M;
    const long long q = pvalid[j] ? p : 0;
    const int ox = (int)(q % g.Wo);
    const int oy = (int)((q / g.Wo) % g.Ho);
    img[j] = q / ((long long)g.Wo * g.Ho);
    iy0[j] = oy * g.sh - g.ph;
    ix0[j] = ox * g.sw - g.pw;
  }

  const int n_steps = (K + BK - 1) / BK;
  uint4 a_reg[2], b_reg[2];

  auto load = [&](int step) {
    const int k0 = step * BK + chunk * 16;
    if (G == 16) {
      // Cin % 16 == 0: the chunk lies inside one tap.
      const int tap = k0 / g.Cin, c = k0 - tap * g.Cin;
      const int dy = tap / g.kw, dx = tap - (tap / g.kw) * g.kw;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int iy = iy0[j] + dy, ix = ix0[j] + dx;
        a_reg[j] = make_uint4(0u, 0u, 0u, 0u);
        if (pvalid[j] && k0 < K && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const long long pix = (img[j] * g.H + iy) * g.W + ix;
          a_reg[j] = *reinterpret_cast<const uint4*>(x + pix * g.x_stride + c);
        }
        const int n = n0 + row + 32 * j;
        b_reg[j] = make_uint4(0u, 0u, 0u, 0u);
        if (n < g.Cout && k0 < K)
          b_reg[j] = *reinterpret_cast<const uint4*>(w + (long long)n * K + k0);
      }
    } else {
      // G-byte words (4 when Cin % 4 == 0, as the Cin 12 stem; else 1), each
      // inside one tap; k >= K reads zero.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t av[4] = {0u, 0u, 0u, 0u}, bv[4] = {0u, 0u, 0u, 0u};
        const int n = n0 + row + 32 * j;
        int tap = k0 / g.Cin, c = k0 - (k0 / g.Cin) * g.Cin;
#pragma unroll
        for (int e = 0; e < 16; e += G) {
          const int k = k0 + e;
          if (k < K) {
            const int dy = tap / g.kw, dx = tap - (tap / g.kw) * g.kw;
            const int iy = iy0[j] + dy, ix = ix0[j] + dx;
            if (pvalid[j] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
              const int8_t* src = x + ((img[j] * g.H + iy) * g.W + ix) * g.x_stride + c;
              if (G == 4) av[e >> 2] = *reinterpret_cast<const uint32_t*>(src);
              else av[e >> 2] |= (uint32_t)(uint8_t)*src << (8 * (e & 3));
            }
            if (n < g.Cout) {
              const int8_t* src = w + (long long)n * K + k;
              if (G == 4) bv[e >> 2] = *reinterpret_cast<const uint32_t*>(src);
              else bv[e >> 2] |= (uint32_t)(uint8_t)*src << (8 * (e & 3));
            }
          }
          c += G;
          if (c == g.Cin) { c = 0; ++tap; }
        }
        a_reg[j] = make_uint4(av[0], av[1], av[2], av[3]);
        b_reg[j] = make_uint4(bv[0], bv[1], bv[2], bv[3]);
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  load(0);
  for (int step = 0; step < n_steps; ++step) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(&As[row + 32 * j][chunk * 16]) = a_reg[j];
      *reinterpret_cast<uint4*>(&Bs[row + 32 * j][chunk * 16]) = b_reg[j];
    }
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);  // in flight during the MMAs below
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + gq;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 4]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 4]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + tig * 4]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + gq;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + tig * 4]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: each accumulator element (pixel p, channel n) goes to the
  // segment that holds n, in that segment's kind.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + warp_n * 32 + ni * 8 + tig * 2 + e;
      if (n >= g.Cout) continue;
      // The segment holding n, selected with constant indices so the
      // descriptor stays in parameter space.
      int kind = segs.kind[0], start = 0;
      long long ostride = segs.stride[0];
      void* outp = segs.out[0];
#pragma unroll
      for (int i = 1; i < MAX_SEGS; ++i)
        if (i < segs.n && n >= segs.end[i - 1]) {
          kind = segs.kind[i];
          start = segs.end[i - 1];
          ostride = segs.stride[i];
          outp = segs.out[i];
        }
      const int nc = n - start;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long p = m0 + warp_m * 32 + mi * 16 + gq + half * 8;
          if (p >= M) continue;
          const int a = acc[mi][ni][2 * half + e];
          const long long off = p * ostride + nc;
          if (kind == SHIFT) {
            int v = (int)((unsigned)a + (unsigned)bias_i[n]) >> shift[n];
            v = min(max(v, 0), 127);
            reinterpret_cast<int8_t*>(outp)[off] = (int8_t)v;
          } else if (kind == F32) {
            float f = __fadd_rn(__fmul_rn((float)a, mul[n]), add[n]);
            f = fminf(fmaxf(f, 0.f), 127.f);
            reinterpret_cast<int8_t*>(outp)[off] = (int8_t)(int)f;
          } else if (kind == DEQUANT) {
            const float f = fmaxf(__fadd_rn(__fmul_rn((float)a, mul[n]), add[n]), 0.f);
            reinterpret_cast<__nv_bfloat16*>(outp)[off] = __float2bfloat16_rn(f);
          } else {
            reinterpret_cast<int*>(outp)[off] = a;
          }
        }
    }
  }
}

}  // namespace

extern "C" int conv_int8(const void* x, long long x_stride, const void* w, int B, int H,
                         int W, int Cin, int Ho, int Wo, int Cout, int kh, int kw, int sh,
                         int sw, int ph, int pw, const void* bias_i, const void* shift,
                         const void* mul, const void* add, int nseg, const int* seg_end,
                         const int* seg_kind, const long long* seg_stride,
                         void* const* seg_out, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS || seg_end[nseg - 1] != Cout) return (int)cudaErrorInvalidValue;
  Segs segs;
  segs.n = nseg;
  for (int s = 0; s < MAX_SEGS; ++s) {
    const bool on = s < nseg;
    segs.end[s] = on ? seg_end[s] : Cout;
    segs.kind[s] = on ? seg_kind[s] : PRE;
    segs.stride[s] = on ? seg_stride[s] : 0;
    segs.out[s] = on ? seg_out[s] : nullptr;
  }
  const Geom g{B, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, ph, pw, x_stride};
  const long long M = (long long)B * Ho * Wo;
  if (M <= 0 || Cout <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  auto aligned = [&](int a) {
    return Cin % a == 0 && x_stride % a == 0 && (uintptr_t)x % a == 0 && (uintptr_t)w % a == 0;
  };
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  const int* bip = (const int*)bias_i;
  const int* shp = (const int*)shift;
  const float* mup = (const float*)mul;
  const float* adp = (const float*)add;
  if (aligned(16))
    conv_int8_kernel<16><<<grid, THREADS, 0, st>>>(xp, wp, g, bip, shp, mup, adp, segs);
  else if (aligned(4))
    conv_int8_kernel<4><<<grid, THREADS, 0, st>>>(xp, wp, g, bip, shp, mup, adp, segs);
  else
    conv_int8_kernel<1><<<grid, THREADS, 0, st>>>(xp, wp, g, bip, shp, mup, adp, segs);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

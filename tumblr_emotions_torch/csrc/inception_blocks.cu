// Hopper (sm_90a) kernels for the fused Inception-A/B blocks.
//
// Replaces tumblr_emotions_tpu/ops/fused_inception.py::fused_inception_a and
// ::fused_inception_b (the Pallas plane kernels, with their _conv_same and
// _avg_pool3).  The Python host functions in ops/fused_inception.py launch
// these two kernels once per conv / pool of a block.
//
// conv_same_bias_relu: stride-1 SAME conv on NHWC bf16 as an implicit GEMM,
//   M = B*H*W pixels, N = Cout, K = kh*kw*Cin (tap-major, then channel).
//   Out-of-image taps read zero (the TPU kernel's _valid_mask).  bf16
//   tensor-core MMA (mma.sync m16n8k16) into an f32 accumulator, then
//   + bias, ReLU, round to bf16, stored into a channel slice of the output.
//   What bounds it: the Inception-A/B convs do 570-840 FLOP per byte of
//   block input and output, above the H100's 295, so the tensor cores are
//   the limit.  The design: 64x64 output tiles, 4 warps each owning 32x32,
//   K in steps of 32; the next K-step's global loads are issued into
//   registers before the current step's MMAs, so their latency overlaps
//   the math.  (wgmma, TMA and a deeper shared-memory ring are later work.)
//   Input and output are read/written at a pixel stride, so a branch can
//   read or write a channel slice of a larger tensor.
//
// avg_pool3_same: 3x3 stride-1 SAME average pool with count_include_pad =
//   False, summed in f32 in the TPU kernel's tap order, divided by the count
//   of in-image taps, rounded to bf16.  Memory bound: one read of the input
//   (neighbours come from L1/L2) and one write of the output, so each
//   thread moves 8 channels (16 bytes) per load and store.  C % 8 == 0.
//
// Each extern "C" entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // pixels per tile
constexpr int BN = 64;       // output channels per tile
constexpr int BK = 32;       // input channels per K-step
constexpr int PAD = 8;       // shared-memory row padding (keeps 16-byte rows, spreads banks)
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__global__ void __launch_bounds__(THREADS)
conv_same_bias_relu_kernel(const __nv_bfloat16* __restrict__ x, int x_stride,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int out_stride,
                           int B, int H, int W, int Cin, int Cout, int kh, int kw) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // [pixel][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][BN + PAD];  // [k][cout]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;       // mma fragment coordinates
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A tile loads: each thread copies 8 channels (16 bytes) of rows
  // a_row and a_row + 32.
  const int a_chunk = tid & 3, a_row = tid >> 2;
  int py[2], px[2];
  long long pb[2];
  bool pvalid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long p = m0 + a_row + 32 * j;
    pvalid[j] = p < M;
    const long long q = pvalid[j] ? p : 0;
    px[j] = (int)(q % W);
    py[j] = (int)((q / W) % H);
    pb[j] = q / ((long long)W * H);
  }
  // B tile loads: each thread copies 8 output channels of k-rows b_row and b_row + 16.
  const int b_chunk = tid & 7, b_row = tid >> 3;

  const int n_csteps = (Cin + BK - 1) / BK;
  const int n_steps = kh * kw * n_csteps;
  uint4 a_reg[2], b_reg[2];

  auto load = [&](int step) {
    const int tap = step / n_csteps;
    const int c0 = (step - tap * n_csteps) * BK;
    const int dy = tap / kw - kh / 2, dx = tap % kw - kw / 2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + a_chunk * 8;
      const int yy = py[j] + dy, xx = px[j] + dx;
      a_reg[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pvalid[j] && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const long long pix = (pb[j] * H + yy) * W + xx;
        a_reg[j] = *reinterpret_cast<const uint4*>(x + pix * x_stride + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = c0 + b_row + 16 * j;
      const int n = n0 + b_chunk * 8;
      b_reg[j] = make_uint4(0u, 0u, 0u, 0u);
      if (k < Cin && n < Cout)
        b_reg[j] = *reinterpret_cast<const uint4*>(w + ((long long)tap * Cin + k) * Cout + n);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  load(0);
  for (int step = 0; step < n_steps; ++step) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(&As[a_row + 32 * j][a_chunk * 8]) = a_reg[j];
      *reinterpret_cast<uint4*>(&Bs[b_row + 16 * j][b_chunk * 8]) = b_reg[j];
    }
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);  // in flight during the MMAs below
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 2]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 2]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 2 + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + g;
        b[ni][0] = pack_bf16(Bs[ks + tig * 2][n], Bs[ks + tig * 2 + 1][n]);
        b[ni][1] = pack_bf16(Bs[ks + tig * 2 + 8][n], Bs[ks + tig * 2 + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: + bias, ReLU, round to bf16, two channels per store.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + warp_n * 32 + ni * 8 + tig * 2;
    if (n >= Cout) continue;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long p = m0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (p >= M) continue;
        const float v0 = fmaxf(acc[mi][ni][2 * half] + b0, 0.f);
        const float v1 = fmaxf(acc[mi][ni][2 * half + 1] + b1, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(out + p * out_stride + n) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// One thread per 8 channels of one output pixel: 16-byte loads and stores.
__global__ void avg_pool3_same_kernel(const __nv_bfloat16* __restrict__ x,
                                      __nv_bfloat16* __restrict__ out,
                                      int B, int H, int W, int C) {
  const int C8 = C / 8;
  const long long total = (long long)B * H * W * C8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C8) * 8;
    const long long p = i / C8;
    const int xx = (int)(p % W);
    const int yy = (int)((p / W) % H);
    const long long b = p / ((long long)W * H);
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int cnt = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y2 = yy + dy;
      if (y2 < 0 || y2 >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int x2 = xx + dx;
        if (x2 < 0 || x2 >= W) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(x + ((b * H + y2) * W + x2) * C + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          s[2 * j] += f.x;
          s[2 * j + 1] += f.y;
        }
        ++cnt;
      }
    }
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      oh[j] = __floats2bfloat162_rn(s[2 * j] / (float)cnt, s[2 * j + 1] / (float)cnt);
    *reinterpret_cast<uint4*>(out + p * C + c) = o;
  }
}

}  // namespace

extern "C" int conv_same_bias_relu_bf16(const void* x, int x_stride, const void* w,
                                        const void* bias, void* out, int out_stride,
                                        int B, int H, int W, int Cin, int Cout,
                                        int kh, int kw, void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv_same_bias_relu_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, x_stride, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, out_stride, B, H, W, Cin, Cout, kh, kw);
  return (int)cudaGetLastError();
}

extern "C" int avg_pool3_same_bf16(const void* x, void* out, int B, int H, int W,
                                   int C, void* stream) {
  const long long total = (long long)B * H * W * (C / 8);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  avg_pool3_same_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

extern "C" const char* inception_blocks_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

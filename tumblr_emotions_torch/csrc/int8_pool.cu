// Hopper (sm_90a) int8 3x3 stride-2 VALID max pool for the int8 serving engine.
//
// Replaces experiments/pallas_pool.py::pallas_pool_3d and ::pallas_pool_2d:
// one function (int8 3x3/2 VALID max pool, MaxPool_3a's [B,147,147,32]) in
// two TPU layouts; K4b's lane packing is a device of the TPU's (8,128)
// tiling, so this one kernel is the counterpart of both.  It also carries
// the optional rescale of tumblr_emotions_tpu/ops/quant.py::_Int8Ops.maxpool
// (the pool branch of Mixed_6a/7a requantized to the block's scale):
//     clip(float(max) * r + 0.5, 0, 127) -> int8 by truncation,
// with __fmul_rn/__fadd_rn so that no FMA is contracted.
//
// What bounds it: 9 int8 reads per output from a 2.25x smaller output, i.e.
// one read of the input and one write of the output at 3.35 TB/s; neighbours
// come from L1/L2.  Each thread takes 16 channels of one output pixel in
// 16-byte loads and stores and maxes them with __vmaxs4 (4 bytes per
// instruction), when C, the pixel strides and the pointers are multiples of
// 16; otherwise one channel per thread.  Input and output are read and
// written at a pixel stride, so the output may be a channel slice of a
// block's concat buffer.
//
// The extern "C" entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int8_t rescale_byte(int v, float r) {
  float f = __fadd_rn(__fmul_rn((float)v, r), 0.5f);
  f = fminf(fmaxf(f, 0.f), 127.f);
  return (int8_t)(int)f;
}

__device__ __forceinline__ uint32_t rescale_word(uint32_t w, float r) {
  uint32_t o = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = (int)(int8_t)((w >> (8 * b)) & 0xffu);
    o |= (uint32_t)(uint8_t)rescale_byte(v, r) << (8 * b);
  }
  return o;
}

__global__ void maxpool_vec_kernel(const int8_t* __restrict__ x, long long x_stride,
                                   int8_t* __restrict__ out, long long out_stride, int B,
                                   int H, int W, int C, int Ho, int Wo, int rescale,
                                   float r) {
  const int C16 = C / 16;
  const long long total = (long long)B * Ho * Wo * C16;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C16) * 16;
    const long long p = i / C16;
    const int ox = (int)(p % Wo);
    const int oy = (int)((p / Wo) % Ho);
    const long long b = p / ((long long)Wo * Ho);
    const int8_t* base = x + ((b * H + 2 * oy) * W + 2 * ox) * x_stride + c;
    uint4 m = *reinterpret_cast<const uint4*>(base);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(base + ((long long)dy * W + dx) * x_stride);
        m.x = __vmaxs4(m.x, v.x);
        m.y = __vmaxs4(m.y, v.y);
        m.z = __vmaxs4(m.z, v.z);
        m.w = __vmaxs4(m.w, v.w);
      }
    if (rescale) {
      m.x = rescale_word(m.x, r);
      m.y = rescale_word(m.y, r);
      m.z = rescale_word(m.z, r);
      m.w = rescale_word(m.w, r);
    }
    *reinterpret_cast<uint4*>(out + p * out_stride + c) = m;
  }
}

__global__ void maxpool_scalar_kernel(const int8_t* __restrict__ x, long long x_stride,
                                      int8_t* __restrict__ out, long long out_stride, int B,
                                      int H, int W, int C, int Ho, int Wo, int rescale,
                                      float r) {
  const long long total = (long long)B * Ho * Wo * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long p = i / C;
    const int ox = (int)(p % Wo);
    const int oy = (int)((p / Wo) % Ho);
    const long long b = p / ((long long)Wo * Ho);
    const int8_t* base = x + ((b * H + 2 * oy) * W + 2 * ox) * x_stride + c;
    int m = -128;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) m = max(m, (int)base[((long long)dy * W + dx) * x_stride]);
    out[p * out_stride + c] = rescale ? rescale_byte(m, r) : (int8_t)m;
  }
}

}  // namespace

extern "C" int maxpool3x3s2_int8(const void* x, long long x_stride, void* out,
                                 long long out_stride, int B, int H, int W, int C,
                                 int rescale, float r, void* stream) {
  const int Ho = (H - 3) / 2 + 1, Wo = (W - 3) / 2 + 1;
  if (H < 3 || W < 3 || B <= 0 || C <= 0) return (int)cudaSuccess;
  const bool vec = C % 16 == 0 && x_stride % 16 == 0 && out_stride % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const long long total = (long long)B * Ho * Wo * (vec ? C / 16 : C);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    maxpool_vec_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const int8_t*)x, x_stride, (int8_t*)out, out_stride, B, H, W, C, Ho, Wo, rescale, r);
  else
    maxpool_scalar_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const int8_t*)x, x_stride, (int8_t*)out, out_stride, B, H, W, C, Ho, Wo, rescale, r);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_pool_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

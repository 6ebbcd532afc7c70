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
//   output channel's K run is contiguous).  int32 accumulator.  Out-of-image
//   taps read zero (SAME padding).  Epilogue per output-channel segment (at
//   most 4 segments, each with its own output tensor, pixel stride and
//   kind), so a packed 1x1 conv is one launch:
//     SHIFT   clamp((acc + b_i) >> k, 0, 127) -> int8 (wrapping int32 add,
//             arithmetic shift: bit-exact with the reference)
//     F32     clip(float(acc) * m + bq, 0, 127) -> int8 by truncation
//     DEQUANT max(float(acc) * m + b, 0) -> bf16 (round to nearest even)
//     PRE     acc -> int32
//   The float steps use __fmul_rn/__fadd_rn so nvcc cannot contract them
//   into an FMA that the reference does not do.
//
// What bounds it: at B=64 the engine's convs do 2*K int ops per output
//   byte (Conv2d_4a: 89 GOP against 38 MB, 2,300 ops per byte), above the
//   H100's 1,979 TOP/s / 3.35 TB/s = 590 ops per byte, so by the roofline
//   the tensor cores are the limit wherever K is large and the stem convs
//   (Cin 12-64, 1.4 M pixels) are near the memory bound.  In practice an
//   implicit GEMM reads every input pixel once per tap and every weight
//   once per pixel tile, from L2 into shared memory: (BM + BN) bytes per K
//   byte against BM * BN MACs.  Measured on the H100 (clock64 probes of
//   one block), that fill and the output's stores, not the MMAs, take most
//   of the time.
//
// The design (conv_int8_wgmma):
//   - one warpgroup (128 threads) per 64 output pixels; each issues
//     wgmma.mma_async m64nBNk32 .s32.s8.s8 with A (pixels x K) and B
//     (channels x K) both read from shared memory through descriptors,
//     128-byte rows in the 128-byte swizzle, int32 accumulators in
//     registers;
//   - tiles of BM in {64, 128} pixels by BN in {32, 64, 96, 128, 192, 256}
//     channels (not 128 x 256), chosen per conv by
//     ops/int8_conv.py::pick_tile, a plain Python rule fitted to this
//     kernel's measured times: at least one block per SM, narrow tiles for
//     the Cout 32 stems and for the 8x8 convs, 128 x 192 where the weights
//     are large;
//   - persistent blocks, one wave: block b keeps one channel tile and walks
//     every (gridDim / channel tiles)-th pixel tile, and the K steps of all
//     its tiles are one stream through a 3-slot ring of 128-byte K steps in
//     dynamic shared memory, filled two steps ahead of the MMAs, across tile
//     boundaries: the gathered pixel tile with cp.async (16-byte copies,
//     4-byte ones on the Cin 12 stem; out-of-image taps and the K tail
//     zero-filled with src-size 0, not branched around), the weight tile
//     as one TMA box ([BN][128 bytes] of the [Cout][K] weights, the tensor
//     map made through the driver's entry point, an mbarrier per slot) where
//     the copies are 16 bytes, else with cp.async too; one barrier per K
//     step;
//   - the tap and channel of each thread's K chunk are counters advanced
//     once per step, and the next pixel tile's coordinates are carried
//     forward by a fixed pixel count: no division in the K loop or between
//     tiles; each pixel row keeps a 64-bit base pointer and every tap adds
//     one 32-bit offset;
//   - the epilogue converts the accumulators in registers (constants of
//     the block's channels staged in shared memory once) into an output
//     tile in shared memory laid out as the rows of each segment's slice,
//     and the bulk-copy engine (cp.async.bulk) stores it, one copy where
//     the rows are contiguous in global memory, else one per row, while the
//     block goes on to its next tile; element stores only where a row is
//     not 16-byte aligned.
//   No split-K: the shift epilogue needs the whole accumulator.
//
// conv_int8_bytes: the earlier mma.sync m16n8k32 kernel with byte loads,
//   kept for inputs whose channels or strides are not multiples of 4 bytes
//   (the Cin 3 stem of the float front).  The served s2d program never
//   takes it; ops/int8_conv.py counts its launches apart.
//
// The extern "C" entry point launches on the given stream of the given
// device (the caller's current one), allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int MAX_SEGS = 4;
constexpr int BK = 128;      // K bytes per ring stage: one 128-byte swizzle row

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

struct Consts {
  const int* bias_i;
  const int* shift;
  const float* mul;
  const float* add;
};

// ---- the epilogue of one accumulator element ----

__device__ __forceinline__ int epi_shift(int a, int b_i, int k) {
  const int v = (int)((unsigned)a + (unsigned)b_i) >> k;
  return min(max(v, 0), 127);
}

__device__ __forceinline__ int epi_f32(int a, float m, float b) {
  const float f = fminf(fmaxf(__fadd_rn(__fmul_rn((float)a, m), b), 0.f), 127.f);
  return (int)f;
}

__device__ __forceinline__ __nv_bfloat16 epi_dequant(int a, float m, float b) {
  return __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn((float)a, m), b), 0.f));
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both from shared.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// ---- the wgmma kernel ----

// Ring depth: loads run two K steps ahead of the MMAs, which are waited
// for within their step.  A deeper ring measured no faster on the H100 and
// leaves fewer blocks resident on an SM to overlap one block's epilogue
// with another's loads.
constexpr int STAGES = 3;

// The segment table, copied to shared memory so that the epilogue can
// loop over it at run time.
struct SegTable {
  int end[MAX_SEGS];
  int kind[MAX_SEGS];
  long long stride[MAX_SEGS];
  char* out[MAX_SEGS];
};

// One tile's parts (a segment's channels within the tile), built per tile
// by thread 0: tile columns [lo, hi), element bytes, where the part's rows
// lie in the output tile `ob` ([rows][rowb] bytes from `off`), the global
// address of its first row and the global row stride, and how it is
// stored: 2 = one bulk copy (the rows are contiguous in global memory),
// 1 = a bulk copy per row, 0 = element stores (a row not 16-byte aligned).
struct Parts {
  int n;
  int lo[MAX_SEGS], hi[MAX_SEGS], es[MAX_SEGS], kind[MAX_SEGS];
  int off[MAX_SEGS], rowb[MAX_SEGS], how[MAX_SEGS];
  char* dst[MAX_SEGS];
  long long rstride[MAX_SEGS];
};

// One column's place in the output tile, for tiles of several parts:
// kind | element bytes << 4, byte offset of row 0, row bytes.
struct ColDesc {
  int kind_es, off, rowb, pad;
};

template <int BM, int BN>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  // ring + output tile + channel constants + column descriptors + segment
  // table + parts + ring barriers + alignment slack
  return STAGES * (BM + BN) * BK + BM * BN * 4 + 64 + 16 * BN + 16 * BN + 128 + 256 + 64 +
         1024;
}

// The output bits of accumulator `a` in a segment of KIND, with the
// constants of its channel.
template <int KIND>
__device__ __forceinline__ uint32_t epi_bits(int a, int b_i, int k, float m, float b) {
  if (KIND == SHIFT) return (uint32_t)epi_shift(a, b_i, k);
  if (KIND == F32) return (uint32_t)epi_f32(a, m, b);
  if (KIND == DEQUANT) return (uint32_t)__bfloat16_as_ushort(epi_dequant(a, m, b));
  return (uint32_t)a;
}

__device__ __forceinline__ void store_bits(char* d, uint32_t v, int es) {
  if (es == 1) *reinterpret_cast<uint8_t*>(d) = (uint8_t)v;
  else if (es == 2) *reinterpret_cast<uint16_t*>(d) = (uint16_t)v;
  else *reinterpret_cast<uint32_t*>(d) = v;
}

// Accumulators -> output tile, for a tile in one segment (one part, from
// tile column 0, `w` columns, `rowb` bytes a row).  Each thread holds, per
// 8-column group j, columns 8 j + 2 t + {0, 1} of rows row0 and row0 + 8
// (the wgmma D layout) and stores each pair at once where the row width
// keeps it aligned.
template <int KIND, int BN>
__device__ __forceinline__ void convert_one_part(const int (&acc)[BN / 2], char* ob, int row0,
                                                 int t, int w, int rowb, const int* s_bias,
                                                 const int* s_shift, const float* s_mul,
                                                 const float* s_add) {
  constexpr int E = KIND == DEQUANT ? 2 : KIND == PRE ? 4 : 1;
  const bool pairs = (w & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= w) break;
    int2 bi = make_int2(0, 0), sh = bi;
    float2 mu = make_float2(0.f, 0.f), ad = mu;
    if (KIND == SHIFT) {
      bi = *reinterpret_cast<const int2*>(s_bias + c);
      sh = *reinterpret_cast<const int2*>(s_shift + c);
    } else if (KIND != PRE) {
      mu = *reinterpret_cast<const float2*>(s_mul + c);
      ad = *reinterpret_cast<const float2*>(s_add + c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      char* d = ob + (row0 + 8 * h) * rowb + c * E;
      const uint32_t v0 = epi_bits<KIND>(acc[4 * j + 2 * h], bi.x, sh.x, mu.x, ad.x);
      const uint32_t v1 = epi_bits<KIND>(acc[4 * j + 2 * h + 1], bi.y, sh.y, mu.y, ad.y);
      if (pairs) {
        if (E == 1) *reinterpret_cast<uint16_t*>(d) = (uint16_t)(v0 | (v1 << 8));
        else if (E == 2) *reinterpret_cast<uint32_t*>(d) = v0 | (v1 << 16);
        else *reinterpret_cast<uint2*>(d) = make_uint2(v0, v1);
      } else {
        store_bits(d, v0, E);
        if (c + 1 < w) store_bits(d + E, v1, E);
      }
    }
  }
}

// The same for a tile of several parts whose bounds are all even, pair by
// pair through the column descriptors (a pair never straddles two parts).
template <int BN>
__device__ __forceinline__ void convert_pairs(const int (&acc)[BN / 2], char* ob, int row0,
                                              int t, int w, const ColDesc* cd,
                                              const int* s_bias, const int* s_shift,
                                              const float* s_mul, const float* s_add) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= w) break;
    const ColDesc d = cd[c];
    char* const p0 = ob + d.off + row0 * d.rowb;
    char* const p1 = p0 + 8 * d.rowb;
    const int a00 = acc[4 * j], a01 = acc[4 * j + 1], a10 = acc[4 * j + 2], a11 = acc[4 * j + 3];
    switch (d.kind_es & 15) {
      case SHIFT: {
        const int2 bi = *reinterpret_cast<const int2*>(s_bias + c);
        const int2 sh = *reinterpret_cast<const int2*>(s_shift + c);
        *reinterpret_cast<uint16_t*>(p0) =
            (uint16_t)(epi_shift(a00, bi.x, sh.x) | (epi_shift(a01, bi.y, sh.y) << 8));
        *reinterpret_cast<uint16_t*>(p1) =
            (uint16_t)(epi_shift(a10, bi.x, sh.x) | (epi_shift(a11, bi.y, sh.y) << 8));
        break;
      }
      case F32: {
        const float2 mu = *reinterpret_cast<const float2*>(s_mul + c);
        const float2 ad = *reinterpret_cast<const float2*>(s_add + c);
        *reinterpret_cast<uint16_t*>(p0) =
            (uint16_t)(epi_f32(a00, mu.x, ad.x) | (epi_f32(a01, mu.y, ad.y) << 8));
        *reinterpret_cast<uint16_t*>(p1) =
            (uint16_t)(epi_f32(a10, mu.x, ad.x) | (epi_f32(a11, mu.y, ad.y) << 8));
        break;
      }
      case DEQUANT: {
        const float2 mu = *reinterpret_cast<const float2*>(s_mul + c);
        const float2 ad = *reinterpret_cast<const float2*>(s_add + c);
        *reinterpret_cast<uint32_t*>(p0) = epi_bits<DEQUANT>(a00, 0, 0, mu.x, ad.x) |
                                           (epi_bits<DEQUANT>(a01, 0, 0, mu.y, ad.y) << 16);
        *reinterpret_cast<uint32_t*>(p1) = epi_bits<DEQUANT>(a10, 0, 0, mu.x, ad.x) |
                                           (epi_bits<DEQUANT>(a11, 0, 0, mu.y, ad.y) << 16);
        break;
      }
      default:
        *reinterpret_cast<uint2*>(p0) = make_uint2((uint32_t)a00, (uint32_t)a01);
        *reinterpret_cast<uint2*>(p1) = make_uint2((uint32_t)a10, (uint32_t)a11);
    }
  }
}

// The same for a tile of several parts with an odd bound, column by
// column through the column descriptors.
template <int BN>
__device__ __forceinline__ void convert_parts(const int (&acc)[BN / 2], char* ob, int row0,
                                              int t, int w, const ColDesc* cd,
                                              const int* s_bias, const int* s_shift,
                                              const float* s_mul, const float* s_add) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      if (c >= w) continue;
      const ColDesc d = cd[c];
      const int kind = d.kind_es & 15, es = d.kind_es >> 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = acc[4 * j + 2 * h + e];
        uint32_t v;
        if (kind == SHIFT) v = epi_bits<SHIFT>(a, s_bias[c], s_shift[c], 0.f, 0.f);
        else if (kind == F32) v = epi_bits<F32>(a, 0, 0, s_mul[c], s_add[c]);
        else if (kind == DEQUANT) v = epi_bits<DEQUANT>(a, 0, 0, s_mul[c], s_add[c]);
        else v = (uint32_t)a;
        store_bits(ob + d.off + (row0 + 8 * h) * d.rowb, v, es);
      }
    }
  }
}

// Persistent: block b owns output-channel tile b % n_tiles and every
// (gridDim.x / n_tiles)-th pixel tile from b / n_tiles (the launch makes
// gridDim.x a multiple of n_tiles).  The K steps of all its pixel tiles
// form one stream through the ring, so the next tile's first loads are in
// flight while this tile's last MMAs and its epilogue run.
template <int G, int BM, int BN>
__global__ void __launch_bounds__(2 * BM, 1)
conv_int8_wgmma(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Geom g, int M,
                int K, Consts cst, Segs segs, const __grid_constant__ CUtensorMap w_map) {
  constexpr int THREADS = 2 * BM;              // one warpgroup per 64 pixels
  constexpr int AHEAD = 2;                     // loads run this many K steps ahead
  constexpr int WAIT = STAGES - AHEAD - 1;     // MMA groups left in flight per step
  constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  constexpr int ROW_STEP = THREADS / 8;        // rows between one thread's copies
  constexpr int A_ROWS = BM / ROW_STEP;        // 4
  constexpr int B_ROWS = BN / ROW_STEP;
  constexpr int WPC = 16 / G;                  // copies per 16-byte chunk
  static_assert(BN % 32 == 0 && BN <= 256 && (BM == 64 || BM == 128), "tile");
  static_assert(WAIT >= 0 && BN % ROW_STEP == 0, "ring");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * A_BYTES;
  char* ob = reinterpret_cast<char*>(Bs + STAGES * B_BYTES);    // output tile
  int* s_bias = reinterpret_cast<int*>(ob + BM * BN * 4 + 64);
  int* s_shift = s_bias + BN;
  float* s_mul = reinterpret_cast<float*>(s_shift + BN);
  float* s_add = s_mul + BN;
  ColDesc* cd = reinterpret_cast<ColDesc*>(s_add + BN);
  SegTable* sg = reinterpret_cast<SegTable*>(cd + BN);
  Parts* P = reinterpret_cast<Parts*>(reinterpret_cast<char*>(sg) + 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(P) + 256);

  const int tid = threadIdx.x;
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m_first = blockIdx.x / n_tiles, m_step = gridDim.x / n_tiles;
  if (m_first >= m_tiles) return;
  const int my_tiles = (m_tiles - m_first + m_step - 1) / m_step;

  // The block's channel constants and segment table, read once (visible
  // after the first barrier), and the ring's barriers for the weight tiles,
  // which come by TMA where the copies are 16 bytes.
  if (tid == 0) {
    if constexpr (G == 16) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
#pragma unroll
    for (int s = 0; s < MAX_SEGS; ++s) {
      sg->end[s] = segs.end[s];
      sg->kind[s] = segs.kind[s];
      sg->stride[s] = segs.stride[s];
      sg->out[s] = reinterpret_cast<char*>(segs.out[s]);
    }
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int n = n0 + i;
    const bool on = n < g.Cout;
    s_bias[i] = on ? cst.bias_i[n] : 0;
    s_shift[i] = on ? cst.shift[n] : 0;
    s_mul[i] = on ? cst.mul[n] : 0.f;
    s_add[i] = on ? cst.add[n] : 0.f;
  }

  // Each thread copies K chunk `c` (16 bytes) of rows r0 + ROW_STEP * j of
  // the A and B tiles.  ROW_STEP is a multiple of 8, so all its rows share
  // one swizzled chunk position.
  const int c = tid & 7, r0 = tid >> 3;
  const uint32_t chunk_off = (uint32_t)(r0 * BK + ((c ^ (r0 & 7)) << 4));
  int b_off[B_ROWS];
#pragma unroll
  for (int j = 0; j < B_ROWS; ++j) {
    const int n = n0 + r0 + ROW_STEP * j;
    b_off[j] = n < g.Cout ? n * K : -1;
  }

  // The load cursor: pixel tile l_mt, K byte k_next within it; for each of
  // this thread's A rows its output pixel (img, oy, ox), the top-left input
  // pixel of its window and a 64-bit base; for each copy the tap (dy, dx)
  // and channel of its first byte, advanced by BK per step (a run of G bytes
  // never crosses a tap: Cin % G == 0).  Moving to the block's next pixel
  // tile adds a fixed pixel count, carried through (ox, oy, img) without
  // dividing.
  const int8_t* a_base[A_ROWS];
  int a_iy[A_ROWS], a_ix[A_ROWS], a_ox[A_ROWS], a_oy[A_ROWS], a_img[A_ROWS];
  int k_ch[WPC], k_dy[WPC], k_dx[WPC], k_ch0[WPC], k_dy0[WPC], k_dx0[WPC];
  int l_mt = m_first, k_next = 0;
#pragma unroll
  for (int j = 0; j < A_ROWS; ++j) {
    const int p = m_first * BM + r0 + ROW_STEP * j;
    const int t = p / g.Wo;
    a_ox[j] = p - t * g.Wo;
    a_oy[j] = t % g.Ho;
    a_img[j] = t / g.Ho;
  }
#pragma unroll
  for (int e = 0; e < WPC; ++e) {
    const int k = c * 16 + e * G;
    const int tap = k / g.Cin;
    k_ch0[e] = k - tap * g.Cin;
    k_dy0[e] = tap / g.kw;
    k_dx0[e] = tap - k_dy0[e] * g.kw;
  }
  const int d_pix = m_step * BM, d_t = d_pix / g.Wo;
  const int d_ox = d_pix - d_t * g.Wo, d_oy = d_t % g.Ho, d_img = d_t / g.Ho;
  auto start_tile = [&]() {
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      if (a_img[j] < g.B) {
        a_iy[j] = a_oy[j] * g.sh - g.ph;
        a_ix[j] = a_ox[j] * g.sw - g.pw;
        a_base[j] = x + ((long long)(a_img[j] * g.H + a_iy[j]) * g.W + a_ix[j]) * g.x_stride;
      } else {                                 // past the last pixel: zero rows
        a_iy[j] = -(1 << 29);
        a_ix[j] = 0;
        a_base[j] = x;
      }
    }
#pragma unroll
    for (int e = 0; e < WPC; ++e) {
      k_ch[e] = k_ch0[e];
      k_dy[e] = k_dy0[e];
      k_dx[e] = k_dx0[e];
    }
    k_next = 0;
  };
  auto next_tile = [&]() {
    l_mt += m_step;
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      a_ox[j] += d_ox;
      int carry = a_ox[j] >= g.Wo;
      a_ox[j] -= carry ? g.Wo : 0;
      a_oy[j] += d_oy + carry;
      carry = a_oy[j] >= g.Ho;
      a_oy[j] -= carry ? g.Ho : 0;
      a_img[j] += d_img + carry;
    }
    if (l_mt < m_tiles) start_tile();
  };
  const int K32 = (K + 31) & ~31;              // the MMAs read K up to K32
  const int n_steps = (K + BK - 1) / BK;

  auto load_step = [&](int slot) {
    if (l_mt >= m_tiles) return;               // past the block's last tile
    const uint32_t a_dst = smem_u32(As + slot * A_BYTES) + chunk_off;
    const uint32_t b_dst = smem_u32(Bs + slot * B_BYTES) + chunk_off;
    if constexpr (G == 16) {                   // the weight tile [BN][BK]: one TMA box
      if (tid == 0) {
        mbar_expect_tx(&full[slot], B_BYTES);
        tma_load_2d(Bs + slot * B_BYTES, &w_map, &full[slot], k_next, n0);
      }
    }
#pragma unroll
    for (int e = 0; e < WPC; ++e) {
      const int k = k_next + c * 16 + e * G;
      if (k < K32) {
        const bool kin = k < K;
        const int toff = (k_dy[e] * g.W + k_dx[e]) * (int)g.x_stride + k_ch[e];
#pragma unroll
        for (int j = 0; j < A_ROWS; ++j) {
          const int iy = a_iy[j] + k_dy[e], ix = a_ix[j] + k_dx[e];
          const bool ok = kin && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
          cp_async<G>(a_dst + j * ROW_STEP * BK + e * G, ok ? a_base[j] + toff : x, ok ? G : 0);
        }
        if constexpr (G != 16) {
#pragma unroll
          for (int j = 0; j < B_ROWS; ++j) {
            const bool ok = kin && b_off[j] >= 0;
            cp_async<G>(b_dst + j * ROW_STEP * BK + e * G, ok ? w + b_off[j] + k : w,
                        ok ? G : 0);
          }
        }
      }
      int ch = k_ch[e] + BK;
      while (ch >= g.Cin) {
        ch -= g.Cin;
        if (++k_dx[e] == g.kw) {
          k_dx[e] = 0;
          ++k_dy[e];
        }
      }
      k_ch[e] = ch;
    }
    k_next += BK;
    if (k_next >= K) next_tile();              // on to the block's next pixel tile
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // Step q of the stream lives in slot q % STAGES.  The slot refilled at
  // step q (for q + AHEAD) was last read by step q + AHEAD - STAGES, whose
  // MMAs every warpgroup has waited for (WAIT) before this step's barrier.
  start_tile();
  __syncthreads();                             // the barriers are initialised
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    load_step(s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  const int total = my_tiles * n_steps;
  int c_step = 0, c_mt = m_first;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    load_step((q + AHEAD) % STAGES);
    cp_async_commit();

    const int slot = q % STAGES;
    if constexpr (G == 16) mbar_wait(&full[slot], (q / STAGES) & 1);
    const int nk = min(BK / 32, (K32 - c_step * BK) / 32);   // k32 slices in this step
    const uint64_t da = desc_sw128(As + slot * A_BYTES + wg * 64 * BK);
    const uint64_t db = desc_sw128(Bs + slot * B_BYTES);
    wgmma_fence();
    if (nk == BK / 32) {                       // every step but a K tail
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 32 - 1; ++kk)
        if (kk < nk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<WAIT>();
    if (++c_step < n_steps) continue;

    // ---- the tile's epilogue ----
    // The accumulators are converted in registers into the output tile in
    // shared memory, in the byte layout of each part's rows in global
    // memory, and copied out by the bulk-copy engine while the block goes
    // on to its next tile.
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    bulk_wait_all<true>();                     // the last tile's copies have read `ob`
    const int m0 = c_mt * BM, w = min(n0 + BN, g.Cout) - n0;
    if (tid == 0) {
      int n = 0, off = 0;
      for (int s = 0; s < segs.n; ++s) {
        const int start = s ? sg->end[s - 1] : 0;
        const int lo = max(start, n0), hi = min(sg->end[s], n0 + w);
        if (lo >= hi) continue;
        const int kind = sg->kind[s];
        const int es = kind == DEQUANT ? 2 : kind == PRE ? 4 : 1;
        const long long rstride = sg->stride[s] * es;
        char* dst = sg->out[s] + (long long)m0 * rstride + (long long)(lo - start) * es;
        const int rowb = (hi - lo) * es;
        const bool a16 = rowb % 16 == 0 && (uintptr_t)dst % 16 == 0 && rstride % 16 == 0;
        P->lo[n] = lo - n0;
        P->hi[n] = hi - n0;
        P->es[n] = es;
        P->kind[n] = kind;
        P->off[n] = off;
        P->rowb[n] = rowb;
        P->how[n] = !a16 ? 0 : rstride == rowb ? 2 : 1;
        P->dst[n] = dst;
        P->rstride[n] = rstride;
        off += (BM * rowb + 15) & ~15;
        ++n;
      }
      P->n = n;
    }
    __syncthreads();
    const int n_parts = P->n;
    // A mixed tile whose part bounds are all even is converted pair by pair.
    const bool odd = n_parts > 1 && ((w | P->lo[1] | P->lo[2 < n_parts ? 2 : 1] |
                                      P->lo[3 < n_parts ? 3 : 1]) & 1);
    if (n_parts > 1) {                         // column descriptors of a mixed tile
      for (int c = tid; c < w; c += THREADS) {
        int s = 0;
        while (c >= P->hi[s]) ++s;
        cd[c] = ColDesc{P->kind[s] | (P->es[s] << 4), P->off[s] + (c - P->lo[s]) * P->es[s],
                        P->rowb[s], 0};
      }
      __syncthreads();
    }
    {
      const int lane = tid & 31;
      const int row0 = (tid >> 5) * 16 + (lane >> 2), t = lane & 3;
      if (odd) {
        convert_parts<BN>(acc, ob, row0, t, w, cd, s_bias, s_shift, s_mul, s_add);
      } else if (n_parts > 1) {
        convert_pairs<BN>(acc, ob, row0, t, w, cd, s_bias, s_shift, s_mul, s_add);
      } else {
        const int rowb = P->rowb[0];
        switch (P->kind[0]) {
          case SHIFT:
            convert_one_part<SHIFT, BN>(acc, ob, row0, t, w, rowb, s_bias, s_shift, s_mul, s_add);
            break;
          case F32:
            convert_one_part<F32, BN>(acc, ob, row0, t, w, rowb, s_bias, s_shift, s_mul, s_add);
            break;
          case DEQUANT:
            convert_one_part<DEQUANT, BN>(acc, ob, row0, t, w, rowb, s_bias, s_shift, s_mul,
                                          s_add);
            break;
          default:
            convert_one_part<PRE, BN>(acc, ob, row0, t, w, rowb, s_bias, s_shift, s_mul, s_add);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_proxy_async();                       // the bulk copies read what was just written
    __syncthreads();
    const int rows = min(BM, M - m0);
    for (int s = 0; s < n_parts; ++s) {
      const int how = P->how[s], rowb = P->rowb[s];
      char* const dst = P->dst[s];
      const char* src = ob + P->off[s];
      if (how == 2) {
        if (tid == 0) bulk_store(dst, src, (uint32_t)(rows * rowb));
      } else if (how == 1) {
        for (int r = tid; r < rows; r += THREADS)
          bulk_store(dst + r * P->rstride[s], src + r * rowb, (uint32_t)rowb);
      } else {                                 // element stores
        const int es = P->es[s], n_el = rowb / es;
        for (int i = tid; i < rows * n_el; i += THREADS) {
          const int r = i / n_el, e = i - r * n_el;
          const char* from = src + r * rowb + e * es;
          const uint32_t v = es == 1 ? *reinterpret_cast<const uint8_t*>(from)
                             : es == 2 ? *reinterpret_cast<const uint16_t*>(from)
                                       : *reinterpret_cast<const uint32_t*>(from);
          store_bits(dst + r * P->rstride[s] + e * es, v, es);
        }
      }
    }
    bulk_commit();
    c_step = 0;
    c_mt += m_step;
  }
  cp_async_wait<0>();
  bulk_wait_all<false>();
}

// ---- the byte-load kernel (inputs not 4-byte aligned: the Cin 3 stem) ----

constexpr int BB_M = 64, BB_N = 64, BB_K = 64, BB_PAD = 16, BB_THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(BB_THREADS)
conv_int8_bytes(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Geom g, Consts cst,
                Segs segs) {
  __shared__ __align__(16) int8_t As[BB_M][BB_K + BB_PAD];  // [pixel][k]
  __shared__ __align__(16) int8_t Bs[BB_N][BB_K + BB_PAD];  // [cout][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;        // mma fragment coordinates
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long M = (long long)g.B * g.Ho * g.Wo;
  const long long m0 = (long long)blockIdx.x * BB_M;
  const int n0 = blockIdx.y * BB_N;
  const int K = g.kh * g.kw * g.Cin;

  // Each thread gathers one 16-byte K chunk of rows `row` and `row + 32`,
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

  const int n_steps = (K + BB_K - 1) / BB_K;
  uint4 a_reg[2], b_reg[2];

  auto load = [&](int step) {
    const int k0 = step * BB_K + chunk * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t av[4] = {0u, 0u, 0u, 0u}, bv[4] = {0u, 0u, 0u, 0u};
      const int n = n0 + row + 32 * j;
      int tap = k0 / g.Cin, c = k0 - (k0 / g.Cin) * g.Cin;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + e;
        if (k < K) {
          const int dy = tap / g.kw, dx = tap - (tap / g.kw) * g.kw;
          const int iy = iy0[j] + dy, ix = ix0[j] + dx;
          if (pvalid[j] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
            av[e >> 2] |= (uint32_t)(uint8_t)x[((img[j] * g.H + iy) * g.W + ix) * g.x_stride + c]
                          << (8 * (e & 3));
          if (n < g.Cout)
            bv[e >> 2] |= (uint32_t)(uint8_t)w[(long long)n * K + k] << (8 * (e & 3));
        }
        if (++c == g.Cin) { c = 0; ++tap; }
      }
      a_reg[j] = make_uint4(av[0], av[1], av[2], av[3]);
      b_reg[j] = make_uint4(bv[0], bv[1], bv[2], bv[3]);
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
    for (int ks = 0; ks < BB_K; ks += 32) {
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
          if (kind == SHIFT)
            reinterpret_cast<int8_t*>(outp)[off] = (int8_t)epi_shift(a, cst.bias_i[n], cst.shift[n]);
          else if (kind == F32)
            reinterpret_cast<int8_t*>(outp)[off] = (int8_t)epi_f32(a, cst.mul[n], cst.add[n]);
          else if (kind == DEQUANT)
            reinterpret_cast<__nv_bfloat16*>(outp)[off] = epi_dequant(a, cst.mul[n], cst.add[n]);
          else
            reinterpret_cast<int*>(outp)[off] = a;
        }
    }
  }
}

// ---- launch ----

template <int G, int BM, int BN>
int launch_wgmma(const int8_t* x, const int8_t* w, const Geom& g, int M, int K,
                 const Consts& cst, const Segs& segs, int dev, cudaStream_t st) {
  constexpr int smem = wgmma_smem_bytes<BM, BN>();
  // Per device (the caller's current one): the shared-memory limit raised
  // once, and blocks per SM.
  static int resident[32] = {0};
  if (dev < 0 || dev >= 32) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSuccess;
  if (!resident[dev]) {
    err = cudaFuncSetAttribute(conv_int8_wgmma<G, BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_int8_wgmma<G, BM, BN>,
                                                          2 * BM, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  // A persistent grid: at most one wave, a multiple of the channel tiles.
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  long long blocks = tiles < resident[dev] ? tiles : resident[dev];
  blocks = blocks / n_tiles * n_tiles;
  if (blocks < n_tiles) blocks = n_tiles;
  CUtensorMap w_map = {};
  if (G == 16) {
    err = (cudaError_t)weight_map(w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, g.Cout, BK, BN,
                                   &w_map);
    if (err != cudaSuccess) return (int)err;
  }
  conv_int8_wgmma<G, BM, BN>
      <<<(unsigned)blocks, 2 * BM, smem, st>>>(x, w, g, M, K, cst, segs, w_map);
  return (int)cudaGetLastError();
}

// Every (load bytes, BM, BN) the tile rule (ops/int8_conv.py::CONFIGS) may pick.
#define WGMMA_CONFIGS(X)                                                            \
  X(16, 64, 32) X(16, 64, 64) X(16, 64, 96) X(16, 64, 128) X(16, 64, 192) X(16, 64, 256) \
  X(16, 128, 32) X(16, 128, 64) X(16, 128, 96) X(16, 128, 128) X(16, 128, 192)          \
  X(4, 64, 32) X(4, 64, 64) X(4, 128, 32) X(4, 128, 64)

}  // namespace

extern "C" int conv_int8(const void* x, long long x_stride, const void* w, int B, int H,
                         int W, int Cin, int Ho, int Wo, int Cout, int kh, int kw, int sh,
                         int sw, int ph, int pw, const void* bias_i, const void* shift,
                         const void* mul, const void* add, int nseg, const int* seg_end,
                         const int* seg_kind, const long long* seg_stride,
                         void* const* seg_out, int load_bytes, int bm, int bn, int device,
                         void* stream) {
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
  const Consts cst{(const int*)bias_i, (const int*)shift, (const float*)mul, (const float*)add};
  const long long M = (long long)B * Ho * Wo;
  const long long K = (long long)kh * kw * Cin;
  if (M <= 0 || Cout <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  if (load_bytes == 1) {
    const dim3 grid((unsigned)((M + BB_M - 1) / BB_M), (unsigned)((Cout + BB_N - 1) / BB_N));
    conv_int8_bytes<<<grid, BB_THREADS, 0, st>>>(xp, wp, g, cst, segs);
    return (int)cudaGetLastError();
  }
  // The wgmma kernel indexes pixels, weights and tap offsets in 32 bits.
  auto aligned = [&](int a) {
    return Cin % a == 0 && x_stride % a == 0 && (uintptr_t)x % a == 0 && (uintptr_t)w % a == 0;
  };
  if (M >= (1LL << 31) || K * Cout >= (1LL << 31) ||
      ((long long)kh * W + kw) * x_stride >= (1LL << 31) || !aligned(load_bytes))
    return (int)cudaErrorInvalidValue;
#define DISPATCH(G_, BM_, BN_)                                                  \
  if (load_bytes == G_ && bm == BM_ && bn == BN_)                               \
    return launch_wgmma<G_, BM_, BN_>(xp, wp, g, (int)M, (int)K, cst, segs, device, st);
  WGMMA_CONFIGS(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* int8_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

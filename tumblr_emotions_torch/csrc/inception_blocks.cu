// Hopper (sm_90a) kernel for the fused Inception-A/B blocks.
//
// Replaces tumblr_emotions_tpu/ops/fused_inception.py::fused_inception_a and
// ::fused_inception_b (the Pallas plane kernels with their _conv_same and
// _avg_pool3).  ops/fused_inception.py runs each block as a fixed plan of
// launches of this one kernel: the block's three 1x1 convs over its input
// packed into one launch, each later conv of a branch, and the pool branch
// as the pooled form (5 launches per Inception-A block, 8 per Inception-B).
//
// conv_bf16_wgmma<BM, BN, POOL>: relu(SAME stride-1 conv + f32 bias) on
//   NHWC bf16 as an implicit GEMM, M = B*H*W pixels, N = Cout, K =
//   kh*kw*Cin (tap-major, then channel; the weights are [Cout][K], so each
//   output channel's K run is contiguous).  f32 accumulation, one rounding to
//   bf16.  The output channels are cut into up to 4 segments, each written
//   into its own tensor at its own pixel stride (a channel slice of the
//   block's output, or a branch intermediate).  Out-of-image taps read zero
//   (SAME padding, the TPU kernel's _valid_mask).  POOL: a 1x1 conv whose A
//   operand is the 3x3 stride-1 SAME average of the input with
//   count_include_pad=False, summed in f32 in the TPU kernel's tap order (dy,
//   then dx, from -1 to 1), divided by the count of in-image taps and rounded
//   to bf16 before the product, as _avg_pool3 does; the pooled plane never
//   goes to device memory.
//
// What bounds it: per image, Mixed_5b does 0.62 GFLOP against 1.10 MB of
//   block input and output (570 FLOP per byte), Mixed_6b 0.75 GFLOP against
//   0.89 MB (840), above the H100's 295 FLOP per byte for bf16, so by the
//   roofline the tensor cores are the limit.  In practice an implicit GEMM
//   refills shared memory from L2 once per tap, (BM + BN) * 2 bytes per K
//   element against BM * BN MACs, and the small Cout of the branch convs
//   (32-192) keeps BN small: the fill and the stores, not the MMAs, take
//   the time (as measured for the int8 kernel of the same design).
//
// The design (the int8 kernel's, csrc/int8_conv.cu, in bf16):
//   - one warpgroup (128 threads) per 64 output pixels; each issues
//     wgmma.mma_async m64nBNk16 .f32.bf16.bf16 with A (pixels x K) and B
//     (channels x K) both K-major in shared memory, 128-byte rows (64 bf16)
//     in the 128-byte swizzle, f32 accumulators in registers;
//   - tiles of BM in {64, 128} pixels by BN in {32 ... 256} channels (every
//     Cout of the blocks, and divisors of the packed widths 176, 448, 512,
//     576), chosen per conv by ops/fused_inception.py::pick_tile;
//   - K runs tap after tap in steps of 64 elements, a step spanning two taps
//     where Cin is not a multiple of 64 (48, 96, 160, 288): each 16-byte
//     chunk lies in one tap (Cin % 8 == 0), so only the last step of a tile
//     is partial, padded to 16 and zero-filled;
//   - persistent blocks, one wave: block b keeps one channel tile and walks
//     every (gridDim / channel tiles)-th pixel tile, and the K steps of all
//     its tiles are one stream through a 3-slot ring filled two steps ahead
//     of the MMAs, across tile boundaries: the gathered pixels by cp.async
//     (16-byte copies; out-of-image taps and the K tail zero-filled with
//     src-size 0), the weight tile by one TMA box ([BN][64] of the [Cout][K]
//     weights, an mbarrier per slot); one barrier per K step.  The pooled
//     form's ring holds instead each tile's halo (its pixels and their 3x3
//     neighbours: BM + 2W + 2 consecutive flattened input pixels, one
//     cp.async copy each per K step), from which the threads average the
//     nine taps into the one A stage (st.shared, then fence.proxy.async and
//     a second barrier) right before the MMAs, each thread 4 consecutive
//     pixels, which share their taps: the input is read from L2 once per
//     tile, not nine times, and each tap is converted to f32 about three
//     times, not nine; the division by the tap count is one reciprocal per
//     pixel and an FMA correction per channel, rounded as the division;
//   - the epilogue adds the bias, applies ReLU and rounds in registers into
//     an output tile in shared memory laid out as the rows of each
//     segment's slice, which the bulk-copy engine (cp.async.bulk) stores,
//     one copy where the rows are contiguous in global memory, else one per
//     row, while the block goes on to its next tile.
//
// The extern "C" entry point launches on the given stream of the given
// device (the caller's current one), allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int MAX_SEGS = 4;
constexpr int BK = 64;        // K elements per ring stage: one 128-byte swizzle row of bf16
constexpr int ROWB = 128;     // bytes of a ring row
constexpr int STAGES = 3;     // loads run two K steps ahead of the MMAs

struct Geom {
  int B, H, W, Cin, Cout, kh, kw;
  int x_stride;                 // input pixel stride, in elements
};

struct Segs {
  int n;
  int end[MAX_SEGS];            // exclusive end channel of each segment
  long long stride[MAX_SEGS];   // output pixel stride, in elements
  void* out[MAX_SEGS];
};

// The block's parts (a segment's channels within its channel tile), fixed
// for the block: tile columns [lo, hi), where the part's rows lie in the
// output tile (from byte `off`, `rowb` bytes a row), the global address of
// the part's row of pixel 0 and the global row stride in bytes, and
// whether the rows are contiguous in global memory (one bulk copy a tile).
struct Parts {
  int n;
  int lo[MAX_SEGS], hi[MAX_SEGS], off[MAX_SEGS], rowb[MAX_SEGS], whole[MAX_SEGS];
  char* dst[MAX_SEGS];
  long long rstride[MAX_SEGS];
};

// D[64 x N] += A[64 x 16] * B[N x 16]^T, bf16 x bf16 -> f32, both K-major
// from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<160>(float (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<176>(float (&d)[88], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<224>(float (&d)[112], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Shared memory of a block, but for the pooled form's halo ring: the A
// ring (one A stage in the pooled form, which fills it right before its
// MMAs), the B ring, the output tile, the bias, the column groups, the
// parts, the ring's barriers, alignment slack.
template <int BM, int BN, bool POOL>
__host__ __device__ constexpr int smem_bytes() {
  return (POOL ? 1 : STAGES) * BM * ROWB + STAGES * BN * ROWB + BM * BN * 2 + 4 * BN + BN + 256 +
         8 * STAGES + 1024 + 128;
}

// The pooled form's halo ring: per stage, the input rows of the BM output
// pixels and of their 3x3 neighbours, W + 1 pixels either side.
__host__ __device__ constexpr int halo_bytes(int BM, int W) { return STAGES * (BM + 2 * W + 2) * ROWB; }

static_assert(sizeof(Parts) <= 256, "parts");

// Persistent: block b owns output-channel tile b % n_tiles and every
// (gridDim.x / n_tiles)-th pixel tile from b / n_tiles (the launch makes
// gridDim.x a multiple of n_tiles).  The K steps of all its pixel tiles
// form one stream through the ring, so the next tile's first loads are in
// flight while this tile's last MMAs and its epilogue run.
template <int BM, int BN, bool POOL>
__global__ void __launch_bounds__(2 * BM, 1)
conv_bf16_wgmma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ bias, Geom g,
                int M, int K, Segs segs, const __grid_constant__ CUtensorMap w_map) {
  constexpr int THREADS = 2 * BM;              // one warpgroup per 64 pixels
  constexpr int AHEAD = STAGES - 1;            // loads run this many K steps ahead
  constexpr int A_BYTES = BM * ROWB, B_BYTES = BN * ROWB;
  constexpr int ROW_STEP = THREADS / 8;        // rows between one thread's copies
  constexpr int A_ROWS = BM / ROW_STEP;        // 4
  static_assert(BN % 8 == 0 && BN <= 256 && (BM == 64 || BM == 128), "tile");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  constexpr int A_STAGES = POOL ? 1 : STAGES;
  uint8_t* As = smem;
  uint8_t* Bs = smem + A_STAGES * A_BYTES;
  char* ob = reinterpret_cast<char*>(Bs + STAGES * B_BYTES);    // output tile
  float* s_bias = reinterpret_cast<float*>(ob + BM * BN * 2);
  int2* cg = reinterpret_cast<int2*>(s_bias + BN);              // per 8 columns
  Parts* P = reinterpret_cast<Parts*>(reinterpret_cast<char*>(cg) + BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(P) + 256);
  uint8_t* Hs = reinterpret_cast<uint8_t*>(((uintptr_t)(full + STAGES) + 127) & ~(uintptr_t)127);
  const int halo_rows = BM + 2 * g.W + 2;      // the pooled form's halo, per stage

  const int tid = threadIdx.x;
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m_first = blockIdx.x / n_tiles, m_step = gridDim.x / n_tiles;
  if (m_first >= m_tiles) return;
  const int my_tiles = (m_tiles - m_first + m_step - 1) / m_step;
  const int w = min(n0 + BN, g.Cout) - n0;     // columns of the channel tile

  // The ring's barriers, the block's parts and bias, once.  Segment bounds
  // are multiples of 8 (the launch checks), so each 8-column group lies in
  // one part: its byte offset in the output tile and row bytes go to `cg`.
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    int n = 0, off = 0;
    for (int s = 0; s < segs.n; ++s) {
      const int start = s ? segs.end[s - 1] : 0;
      const int lo = max(start, n0), hi = min(segs.end[s], n0 + w);
      if (lo >= hi) continue;
      P->lo[n] = lo - n0;
      P->hi[n] = hi - n0;
      P->off[n] = off;
      P->rowb[n] = (hi - lo) * 2;
      P->rstride[n] = segs.stride[s] * 2;
      P->dst[n] = reinterpret_cast<char*>(segs.out[s]) + (long long)(lo - start) * 2;
      P->whole[n] = P->rstride[n] == P->rowb[n];
      off += BM * P->rowb[n];
      ++n;
    }
    P->n = n;
  }
  for (int i = tid; i < BN; i += THREADS) s_bias[i] = n0 + i < g.Cout ? bias[n0 + i] : 0.f;
  __syncthreads();
  for (int j = tid; j < BN / 8; j += THREADS) {
    int2 v = make_int2(0, 0);
    if (8 * j < w) {
      int s = 0;
      while (8 * j >= P->hi[s]) ++s;
      v = make_int2(P->off[s] + (8 * j - P->lo[s]) * 2, P->rowb[s]);
    }
    cg[j] = v;
  }

  // Each thread fills K chunk `c` (8 channels, 16 bytes) of rows r0 +
  // ROW_STEP * j of the A tile.  ROW_STEP is a multiple of 8, so all its
  // rows share one swizzled chunk position.
  const int c = tid & 7, r0 = tid >> 3;
  const uint32_t chunk_off = (uint32_t)(r0 * ROWB + ((c ^ (r0 & 7)) << 4));

  // The load cursor: pixel tile l_mt, K element k_next within it; for each
  // of this thread's A rows its output pixel (img, oy, ox), the top-left
  // input pixel of its window and a 64-bit base; the tap (dy, dx) and
  // channel of its chunk, advanced by BK per step (a chunk never crosses a
  // tap: Cin % 8 == 0).  Moving to the block's next pixel tile adds a fixed
  // pixel count, carried through (ox, oy, img) without dividing.
  const __nv_bfloat16* a_base[A_ROWS];
  int a_iy[A_ROWS], a_ix[A_ROWS], a_ox[A_ROWS], a_oy[A_ROWS], a_img[A_ROWS];
  int l_mt = m_first, k_next = 0;
#pragma unroll
  for (int j = 0; j < A_ROWS; ++j) {
    const int p = m_first * BM + r0 + ROW_STEP * j;
    const int t = p / g.W;
    a_ox[j] = p - t * g.W;
    a_oy[j] = t % g.H;
    a_img[j] = t / g.H;
  }
  const int tap0 = c * 8 / g.Cin;
  const int k_ch0 = c * 8 - tap0 * g.Cin, k_dy0 = tap0 / g.kw, k_dx0 = tap0 - k_dy0 * g.kw;
  int k_ch = k_ch0, k_dy = k_dy0, k_dx = k_dx0;
  const int d_pix = m_step * BM, d_t = d_pix / g.W;
  const int d_ox = d_pix - d_t * g.W, d_oy = d_t % g.H, d_img = d_t / g.H;
  auto start_tile = [&]() {
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      if (a_img[j] < g.B) {
        a_iy[j] = a_oy[j] - g.kh / 2;
        a_ix[j] = a_ox[j] - g.kw / 2;
        a_base[j] = x + ((long long)(a_img[j] * g.H + a_iy[j]) * g.W + a_ix[j]) * g.x_stride;
      } else {                                 // past the last pixel: zero rows
        a_iy[j] = -(1 << 29);
        a_ix[j] = 0;
        a_base[j] = x;
      }
    }
    k_ch = k_ch0;
    k_dy = k_dy0;
    k_dx = k_dx0;
    k_next = 0;
  };
  auto next_tile = [&]() {
    l_mt += m_step;
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      a_ox[j] += d_ox;
      int carry = a_ox[j] >= g.W;
      a_ox[j] -= carry ? g.W : 0;
      a_oy[j] += d_oy + carry;
      carry = a_oy[j] >= g.H;
      a_oy[j] -= carry ? g.H : 0;
      a_img[j] += d_img + carry;
    }
    if (l_mt < m_tiles) start_tile();
  };
  const int K16 = (K + 15) & ~15;              // the MMAs read K up to K16
  const int n_steps = (K + BK - 1) / BK;

  auto load_step = [&](int slot) {
    if (l_mt >= m_tiles) return;               // past the block's last tile
    if (tid == 0) {                            // the weight tile [BN][BK]: one TMA box
      mbar_expect_tx(&full[slot], B_BYTES);
      tma_load_2d(Bs + slot * B_BYTES, &w_map, &full[slot], k_next, n0);
    }
    const int k = k_next + c * 8;
    if constexpr (POOL) {
      // The halo of the tile's pixels: flattened input pixels [m0 - W - 1,
      // m0 + BM + W + 1) (a 3x3 neighbour of pixel p is pixel p + dy W +
      // dx), 128 bytes of channels each; those outside [0, M) and the K
      // tail zero-filled.
      uint8_t* const h = Hs + slot * (halo_rows * ROWB) + c * 16;
      const long long f0 = (long long)l_mt * BM - g.W - 1;
      const bool kin = k < K;
      for (int r = r0; r < halo_rows; r += ROW_STEP) {
        const long long f = f0 + r;
        const bool ok = kin && f >= 0 && f < M;
        cp_async<16>(smem_u32(h + r * ROWB), ok ? x + f * g.x_stride + k : x, ok ? 16 : 0);
      }
    } else if (k < K16) {
      uint8_t* const a_dst = As + slot * A_BYTES + chunk_off;
      const bool kin = k < K;
      const int toff = (k_dy * g.W + k_dx) * g.x_stride + k_ch;
#pragma unroll
      for (int j = 0; j < A_ROWS; ++j) {
        const int iy = a_iy[j] + k_dy, ix = a_ix[j] + k_dx;
        const bool ok = kin && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
        cp_async<16>(smem_u32(a_dst + j * ROW_STEP * ROWB), ok ? a_base[j] + toff : x,
                     ok ? 16 : 0);
      }
    }
    int ch = k_ch + BK;
    while (ch >= g.Cin) {
      ch -= g.Cin;
      if (++k_dx == g.kw) {
        k_dx = 0;
        ++k_dy;
      }
    }
    k_ch = ch;
    k_next += BK;
    if (k_next >= K) next_tile();              // on to the block's next pixel tile
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The pooled form's A operand: the 3x3 average of chunk c's 8 channels
  // at each of this thread's 4 consecutive rows R0..R0+3, from the halo in
  // shared memory, summed in f32 in the order dy, then dx, over the in-image
  // taps, divided by their count, rounded to bf16.  Neighbouring rows share
  // their taps: per dy the thread loads and converts 6 pixels, not 12.
  // (cy, cx): the rows' pixels in the tile being multiplied; cy < 0 past
  // the last pixel.
  const int R0 = 4 * r0;
  int cy[4], cx[4];
  auto pool_fill = [&](int slot) {
    const uint8_t* const h = Hs + slot * (halo_rows * ROWB) + c * 16;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const uint8_t* const row = h + (R0 + g.W + dy * g.W) * ROWB;   // pixel R0 - 1, dy
      uint4 t[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) t[k] = *reinterpret_cast<const uint4*>(row + k * ROWB);
      bool in[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          in[i][dx + 1] = cy[i] >= 0 && (unsigned)(cy[i] + dy) < (unsigned)g.H &&
                          (unsigned)(cx[i] + dx) < (unsigned)g.W;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float f[6][4];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&t[k]) + 2 * half;
          const float2 a = __bfloat1622float2(e2[0]), b = __bfloat1622float2(e2[1]);
          f[k][0] = a.x;
          f[k][1] = a.y;
          f[k][2] = b.x;
          f[k][3] = b.y;
        }
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (in[i][dx + 1]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[i][4 * half + e] += f[i + dx + 1][e];
            }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cy[i] >= 0) {
        // s / n, correctly rounded, without a division per channel: q0 =
        // s * (1/n) is within an ulp, and one FMA step on its exact
        // remainder rounds it as the division would (Markstein), for
        // values that neither overflow nor underflow.
        const int ny = min(cy[i] + 1, g.H - 1) - max(cy[i] - 1, 0) + 1;
        const int nx = min(cx[i] + 1, g.W - 1) - max(cx[i] - 1, 0) + 1;
        const float n = (float)(ny * nx), rn = 1.f / n;
        float q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float q0 = __fmul_rn(s[i][e], rn);
          q[e] = __fmaf_rn(__fmaf_rn(-q0, n, s[i][e]), rn, q0);
        }
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(q[2 * e], q[2 * e + 1]);
      }
      const int r = R0 + i;
      *reinterpret_cast<uint4*>(As + r * ROWB + ((c ^ (r & 7)) << 4)) = v;
    }
  };

  // Step q of the stream lives in slot q % STAGES.  The slot refilled at
  // step q (for q + AHEAD) was last read by step q - 1, whose MMAs (and, in
  // the pooled form, whose fill from the halo) every thread has finished
  // before this step's first barrier.  The pooled form fills its one A
  // stage from the halo of this step between two barriers.
  start_tile();
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    load_step(s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  const int total = my_tiles * n_steps;
  int c_step = 0, c_mt = m_first;
  for (int q = 0; q < total; ++q) {
    const int slot = q % STAGES;
    cp_async_wait<AHEAD - 1>();
    if constexpr (!POOL) fence_proxy_async();
    __syncthreads();
    load_step((q + AHEAD) % STAGES);
    cp_async_commit();
    if constexpr (POOL) {
      if (c_step == 0) {                       // the pixels of the tile being multiplied
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = c_mt * BM + R0 + i;
          const int t = p / g.W;
          cx[i] = p - t * g.W;
          cy[i] = p < M ? t % g.H : -1;
        }
      }
      pool_fill(slot);
      fence_proxy_async();
      __syncthreads();
    }

    mbar_wait(&full[slot], (q / STAGES) & 1);
    const int nk = min(BK / 16, (K16 - c_step * BK) / 16);   // k16 slices in this step
    const uint64_t da = desc_sw128(As + (POOL ? 0 : slot * A_BYTES) + wg * 64 * ROWB);
    const uint64_t db = desc_sw128(Bs + slot * B_BYTES);
    wgmma_fence();
    if (nk == BK / 16) {                       // every step but a K tail
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16 - 1; ++kk)
        if (kk < nk) wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (++c_step < n_steps) continue;

    // ---- the tile's epilogue ----
    // + bias, ReLU and the bf16 round in registers, into the output tile in
    // shared memory in the byte layout of each part's rows in global
    // memory, copied out by the bulk-copy engine while the block goes on to
    // its next tile.
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    bulk_wait_all<true>();                     // this thread's last copies have read `ob`
    __syncthreads();
    const int m0 = c_mt * BM;
    {
      const int lane = tid & 31;
      const int row0 = (tid >> 5) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (8 * j >= w) break;
        const int2 d = cg[j];
        char* const p0 = ob + d.x + 4 * t + row0 * d.y;
        const float2 b = *reinterpret_cast<const float2*>(s_bias + 8 * j + 2 * t);
        *reinterpret_cast<__nv_bfloat162*>(p0) =
            __floats2bfloat162_rn(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(p0 + 8 * d.y) = __floats2bfloat162_rn(
            fmaxf(acc[4 * j + 2] + b.x, 0.f), fmaxf(acc[4 * j + 3] + b.y, 0.f));
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_proxy_async();                       // the bulk copies read what was just written
    __syncthreads();
    const int rows = min(BM, M - m0);
    for (int s = 0; s < P->n; ++s) {
      const int rowb = P->rowb[s];
      const long long rstride = P->rstride[s];
      char* const dst = P->dst[s] + (long long)m0 * rstride;
      const char* src = ob + P->off[s];
      if (P->whole[s]) {
        if (tid == 0) bulk_store(dst, src, (uint32_t)(rows * rowb));
      } else {
        for (int r = tid; r < rows; r += THREADS)
          bulk_store(dst + r * rstride, src + r * rowb, (uint32_t)rowb);
      }
    }
    bulk_commit();
    c_step = 0;
    c_mt += m_step;
  }
  cp_async_wait<0>();
  bulk_wait_all<false>();
}

// ---- launch ----

template <int BM, int BN, bool POOL>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias, const Geom& g,
           int M, int K, const Segs& segs, int dev, cudaStream_t st) {
  constexpr int MAX_SMEM = 232448;             // what a block may use on an H100
  const int smem = smem_bytes<BM, BN, POOL>() + (POOL ? halo_bytes(BM, g.W) : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // Per device (the caller's current one): the shared-memory limit raised
  // once, and blocks per SM, for the last few halo sizes.
  struct Resident {
    int smem, blocks;
  };
  static Resident resident[32][4] = {};
  if (dev < 0 || dev >= 32) return (int)cudaErrorInvalidDevice;
  Resident* r = nullptr;
  for (int i = 0; i < 4 && !r; ++i)
    if (resident[dev][i].smem == smem) r = &resident[dev][i];
  cudaError_t err = cudaSuccess;
  if (!r) {
    if (!resident[dev][0].smem && !resident[dev][1].smem && !resident[dev][2].smem &&
        !resident[dev][3].smem)
      err = cudaFuncSetAttribute(conv_bf16_wgmma<BM, BN, POOL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_bf16_wgmma<BM, BN, POOL>,
                                                          2 * BM, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int i = 0;
    while (i < 3 && resident[dev][i].smem) ++i;   // a free entry, else the last
    resident[dev][i] = Resident{smem, per_sm * sms};
    r = &resident[dev][i];
  }
  // A persistent grid: at most one wave, a multiple of the channel tiles.
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  long long blocks = tiles < r->blocks ? tiles : r->blocks;
  blocks = blocks / n_tiles * n_tiles;
  if (blocks < n_tiles) blocks = n_tiles;
  CUtensorMap w_map;
  err = (cudaError_t)weight_map(w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, g.Cout, BK, BN, &w_map);
  if (err != cudaSuccess) return (int)err;
  conv_bf16_wgmma<BM, BN, POOL>
      <<<(unsigned)blocks, 2 * BM, smem, st>>>(x, bias, g, M, K, segs, w_map);
  return (int)cudaGetLastError();
}

// Every (BM, BN, pooled) the tile rule (ops/fused_inception.py::CONFIGS) may pick.
#define BF16_CONFIGS(X)                                                                     \
  X(64, 32, 0) X(64, 48, 0) X(64, 64, 0) X(64, 96, 0) X(64, 128, 0) X(64, 160, 0)          \
  X(64, 176, 0) X(64, 192, 0) X(64, 224, 0) X(64, 256, 0)                                  \
  X(128, 32, 0) X(128, 48, 0) X(128, 64, 0) X(128, 96, 0) X(128, 128, 0) X(128, 160, 0)    \
  X(128, 176, 0) X(128, 192, 0) X(128, 224, 0) X(128, 256, 0)                              \
  X(64, 32, 1) X(64, 64, 1) X(64, 192, 1) X(128, 32, 1) X(128, 64, 1) X(128, 192, 1)

}  // namespace

extern "C" int conv_bf16(const void* x, long long x_stride, const void* w, const void* bias,
                         int B, int H, int W, int Cin, int Cout, int kh, int kw, int pooled,
                         int nseg, const int* seg_end, const long long* seg_stride,
                         void* const* seg_out, int bm, int bn, int device, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS || seg_end[nseg - 1] != Cout || kh % 2 == 0 || kw % 2 == 0 ||
      (pooled && (kh != 1 || kw != 1)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies and bulk stores: channels, strides and pointers in
  // multiples of 8 elements.
  Segs segs;
  segs.n = nseg;
  for (int s = 0; s < MAX_SEGS; ++s) {
    const bool on = s < nseg;
    segs.end[s] = on ? seg_end[s] : Cout;
    segs.stride[s] = on ? seg_stride[s] : 0;
    segs.out[s] = on ? seg_out[s] : nullptr;
    if (on && ((seg_end[s] - (s ? seg_end[s - 1] : 0)) <= 0 ||
               (seg_end[s] - (s ? seg_end[s - 1] : 0)) % 8 || seg_stride[s] % 8 ||
               (uintptr_t)seg_out[s] % 16))
      return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * H * W;
  const long long K = (long long)kh * kw * Cin;
  if (M <= 0 || Cout <= 0) return (int)cudaSuccess;
  // The kernel indexes pixels, weights and tap offsets in 32 bits.
  if (Cin % 8 || x_stride % 8 || (uintptr_t)x % 16 || (uintptr_t)w % 16 || M >= (1LL << 31) ||
      K * Cout >= (1LL << 31) || ((long long)(kh + 2) * W + kw + 2) * x_stride >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, Cin, Cout, kh, kw, (int)x_stride};
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const __nv_bfloat16* wp = (const __nv_bfloat16*)w;
  const float* bp = (const float*)bias;
#define DISPATCH(BM_, BN_, POOL_)                                                      \
  if (bm == BM_ && bn == BN_ && pooled == POOL_)                                       \
    return launch<BM_, BN_, (POOL_ != 0)>(xp, wp, bp, g, (int)M, (int)K, segs, device, st);
  BF16_CONFIGS(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* inception_blocks_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

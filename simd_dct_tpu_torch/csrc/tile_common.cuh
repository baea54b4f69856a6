// Device and host helpers of the strip-tile kernels (color32.cu,
// color420.cu, stereo.cu, tiles.cu, dct32.cu, encq.cu): exact byte <-> f32
// conversions that keep off the conversion unit, the quantizer on them, the
// bulk-copy plumbing (shared addresses, the mbarrier wait, bulk loads and
// stores, 3-D tensor copies and stores, the bulk-group waits and the proxy
// fence), the DCT basis as compile-time
// values, the walk, the plain row loads and the crossing buffers of tiles
// of one strip row, the encode's two passes, the decode's dequantizer and
// its two passes with the pixel rounding and packing, the scales in shared
// memory, the colour kernels' crossing buffer, and
// cuTensorMapEncodeTiled, reached through the runtime, with the planar-RGB
// and the (W, H2, B) view tensor maps built on it.
//
// Every helper keeps the bytes of the thread-per-block forms: u8f is exact,
// rint_bits rounds half to even as rintf does, quantize_byte<R> equals
// dct_common.cuh's quantize<R> for every finite input, and the passes keep
// the order of the golden model's dct2d and idct2d (core/golden.py _dct2d,
// _idct2d).

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint

#include "dct_common.cuh"

namespace {

// Input loads: kTensor one tensor copy a tile (16-byte addresses and
// strides), kPlain the threads' own loads.
enum Variant { kPlain = 0, kTensor = 1 };
constexpr float kTwo23 = 8388608.0f;
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
constexpr unsigned long long kWaitNs = 2000000000ull;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity.  A load that never lands
// (a fault of the kernel) traps after kWaitNs instead of hanging the card.
__device__ __forceinline__ void wait_full(uint64_t* bar, unsigned parity) {
  const unsigned b = saddr(bar);
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = globaltimer();
    else if (globaltimer() - t0 > kWaitNs) __trap();
  }
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Arm `bar` for `bytes` more bytes of bulk loads (its one arrival).
__device__ __forceinline__ void arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// One 1-D bulk load of `bytes` (a multiple of 16, 16-byte addresses) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// One 1-D bulk store of `bytes` out of shared memory, in the thread's bulk
// group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(saddr(src)), "r"(bytes)
               : "memory");
}

// One thread: the 3-D box at (x, y, z) of tensor map `m` into `stage` by one
// tensor copy, completing on `bar` with all `bytes` of the box (past the
// tensor's edge it comes in as zeros).
__device__ __forceinline__ void tensor_load_3d(const CUtensorMap* m, int x, int y, int z,
                                               uint8_t* stage, uint64_t* bar, unsigned bytes) {
  arrive_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(saddr(stage)),
      "l"(m), "r"(x), "r"(y), "r"(z), "r"(saddr(bar))
      : "memory");
}

// The storing thread: `src` to the 3-D box at (x, y, z) of tensor map `m`
// by one tensor store, as its own bulk group (past the tensor's edge
// nothing is written).
__device__ __forceinline__ void tensor_store_3d(const CUtensorMap* m, int x, int y, int z,
                                                const uint8_t* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          m),
      "r"(x), "r"(y), "r"(z), "r"(saddr(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The generic proxy's shared-memory writes, before the bulk stores read them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Exact u8 -> f32 without the conversion unit: 2^23 + b, less 2^23.
__device__ __forceinline__ float u8f(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000u | b), kTwo23);
}

// Byte i of w, exactly as f32, the same way: the byte under the exponent
// of 2^23, less 2^23.
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, 0x5440 + i)), kTwo23);
}

// For |x| <= 2^22: the low bits of x + 1.5*2^23 are rint(x) (ties to even),
// as a two's complement integer in the low byte.
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, kRound));
}

// rint(x) as f32, exactly.
__device__ __forceinline__ float rint_small(float x) {
  return __fsub_rn(__fadd_rn(x, kRound), kRound);
}

// quantize<R> of dct_common.cuh, its bytes, without rintf and int casts.
// rne's +127 is added to the integer bits after the rounding (127 is odd:
// rint(x + 127) is not rint(x) + 127 at ties).
template <int R>
__device__ __forceinline__ uint8_t quantize_byte(float c, float q) {
  if (R == kScalar) return quantize<kScalar>(c, q);
  const float x = __fmul_rn(c, q);
  if (R == kRne) return (uint8_t)(rint_bits(fminf(fmaxf(x, -127.0f), 128.0f)) + 127u);
  return (uint8_t)rint_bits(fminf(fmaxf(__fadd_rn(x, 127.0f), 0.0f), 255.0f));
}

// The DCT basis D[k][n] of dct_common.cuh's kD (the same 64 literals;
// tests/test_torch_core.py holds the two lists equal) as compile-time
// values.  At the constant indices of an unrolled loop each becomes an
// FFMA immediate, where kD's constant bank costs a uniform load for every
// two FMAs (measured on the stereo kernels: PERF.md).  A runtime
// index would put the table in local memory: use constant ones only.
__device__ __forceinline__ float basis(int i) {
  constexpr float t[64] = {
      0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.f6297ep-2f, 0x1.a9b660p-2f, 0x1.1c73b4p-2f, 0x1.8f8b84p-4f,
      -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b660p-2f, -0x1.f6297ep-2f,
      0x1.d906bep-2f, 0x1.87de2ap-3f, -0x1.87de2ap-3f, -0x1.d906bep-2f,
      -0x1.d906bep-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f, 0x1.d906bep-2f,
      0x1.a9b660p-2f, -0x1.8f8b84p-4f, -0x1.f6297ep-2f, -0x1.1c73b4p-2f,
      0x1.1c73b4p-2f, 0x1.f6297ep-2f, 0x1.8f8b84p-4f, -0x1.a9b660p-2f,
      0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.1c73b4p-2f, -0x1.f6297ep-2f, 0x1.8f8b84p-4f, 0x1.a9b660p-2f,
      -0x1.a9b660p-2f, -0x1.8f8b84p-4f, 0x1.f6297ep-2f, -0x1.1c73b4p-2f,
      0x1.87de2ap-3f, -0x1.d906bep-2f, 0x1.d906bep-2f, -0x1.87de2ap-3f,
      -0x1.87de2ap-3f, 0x1.d906bep-2f, -0x1.d906bep-2f, 0x1.87de2ap-3f,
      0x1.8f8b84p-4f, -0x1.1c73b4p-2f, 0x1.a9b660p-2f, -0x1.f6297ep-2f,
      0x1.f6297ep-2f, -0x1.a9b660p-2f, 0x1.1c73b4p-2f, -0x1.8f8b84p-4f,
  };
  return t[i];
}

// Row u's 8 values of a 64-entry table in shared memory (two 16-byte loads).
__device__ __forceinline__ void row_scales(const float* table, int u, float (&q)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(table + u * 8);
  const float4 hi = *reinterpret_cast<const float4*>(table + u * 8 + 4);
  q[0] = lo.x, q[1] = lo.y, q[2] = lo.z, q[3] = lo.w;
  q[4] = hi.x, q[5] = hi.y, q[6] = hi.z, q[7] = hi.w;
}

// -- tiles of NB blocks of one strip row (stereo.cu, encq.cu, dct32.cu) ------

// A CTA's walk over the tiles, numbered over (frame, row of the frame, tile
// of the row): `rows` rows a frame (stereo: its (strip, view) pairs;
// enc-quant and mode32: its strips) of `tpr` tiles, the last of a row
// short where NB does not divide it.  Tile t as mixed-radix digits,
// advanced by the grid's digits with carries, so a step costs no division.
template <int NB>
struct TileWalk {
  unsigned f, r, x;     // the current tile's digits
  unsigned gf, gr, gx;  // the grid's

  __device__ __forceinline__ static void digits(unsigned t, unsigned tpr, unsigned rows,
                                                unsigned& f, unsigned& r, unsigned& x) {
    const unsigned row = t / tpr;
    x = t - row * tpr;
    f = row / rows;
    r = row - f * rows;
  }

  __device__ __forceinline__ TileWalk(unsigned t, unsigned grid, unsigned tpr, unsigned rows) {
    digits(t, tpr, rows, f, r, x);
    digits(grid, tpr, rows, gf, gr, gx);
  }

  __device__ __forceinline__ void advance(unsigned tpr, unsigned rows) {
    x += gx;
    const unsigned cx = x >= tpr;
    x -= cx ? tpr : 0;
    r += gr + cx;
    const unsigned cr = r >= rows;
    r -= cr ? rows : 0;
    f += gf + cr;
  }

  // The current tile's first block of its row, and its blocks in a row of
  // `len`.
  __device__ __forceinline__ int bx0() const { return (int)x * NB; }
  __device__ __forceinline__ int blocks(int len) const { return min(NB, len - bx0()); }
};

// All NT threads: a tile's 8 pixel rows, from `src` on (rows w bytes
// apart), into `stage` (rows 8*NB bytes apart) with 8-byte loads of its
// first n blocks, then a barrier.
template <int NB, int NT>
__device__ __forceinline__ void load_rows_plain(const uint8_t* src, int w, int n,
                                                uint8_t* stage) {
  for (int i = threadIdx.x; i < 8 * NB; i += NT) {
    const int r = i / NB, b = i % NB;
    if (b < n)
      *reinterpret_cast<uint2*>(stage + r * 8 * NB + 8 * b) =
          __ldg(reinterpret_cast<const uint2*>(src + (long long)r * w) + b);
  }
  __syncthreads();
}

// The encode's crossing buffer of a tile of nb blocks: t[u][k] of block b
// at u*8nb + 8b + k, the two 4-float halves of a block swapped when bit 2
// of b is set.  The column pass writes a thread's 2 or 4 columns at a time
// with lanes (blocks x threads of a block, fixed u) and the row pass reads
// 16 bytes at a time with lanes (32 blocks, fixed u): both free of bank
// conflicts.
__device__ __forceinline__ int enc_cross(int u, int k, int b, int nb) {
  return u * 8 * nb + b * 8 + ((((k >> 2) ^ (b >> 2)) & 1) << 2) + (k & 3);
}

// The decode's crossing buffer of a tile of nb blocks: (r, c) of block b;
// a warp's 32 lanes hold one r or one c and 32 blocks.
__device__ __forceinline__ int dec_cross(int r, int c, int b, int nb) {
  return (r * 8 + c) * nb + b;
}

// -- the encode's passes (stereo.cu, tiles.cu, dct32.cu) ---------------------

// dct2d's column pass on one pixel column: t[u] = sum_j D[u][j] x[j], every
// product and sum in dct2d's order.
__device__ __forceinline__ void dct_column(const float (&x)[8], float (&t)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float acc = __fmul_rn(basis(u * 8), x[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) acc = __fmaf_rn(basis(u * 8 + j), x[j], acc);
    t[u] = acc;
  }
}

// dct2d's row pass on one row: c[v] = sum_k t[k] D[v][k], in order.
__device__ __forceinline__ void dct_row(const float (&t)[8], float (&c)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float acc = __fmul_rn(t[0], basis(v * 8));
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fmaf_rn(t[k], basis(v * 8 + k), acc);
    c[v] = acc;
  }
}

// -- the decode's passes (stereo.cu, tiles.cu, color420.cu, dct32.cu) --------

// (b - 127) * q for a record byte b, the difference exact as (2^23 + b) -
// (2^23 + 127), without the conversion unit.
__device__ __forceinline__ float dequant_byte(uint32_t b, float q) {
  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), kTwo23 + 127.0f), q);
}

// idct2d's first pass on one coefficient column: t[j] = sum_u D[u][j] c[u],
// every product and sum in idct2d's order.
__device__ __forceinline__ void idct_column(const float (&c)[8], float (&t)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float acc = __fmul_rn(basis(j), c[0]);
#pragma unroll
    for (int u = 1; u < 8; ++u) acc = __fmaf_rn(basis(u * 8 + j), c[u], acc);
    t[j] = acc;
  }
}

// idct2d's second pass on one row: x[k] = sum_v t[v] D[v][k], in order.
__device__ __forceinline__ void idct_row(const float (&t)[8], float (&x)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = __fmul_rn(t[0], basis(k));
#pragma unroll
    for (int v = 1; v < 8; ++v) acc = __fmaf_rn(t[v], basis(v * 8 + k), acc);
    x[k] = acc;
  }
}

// A pixel of value y (times 255 when N), clipped and rounded half to even
// (clip(rint(y)) == rint(clip(y)): the limits are integers), in the low
// byte.
template <bool N>
__device__ __forceinline__ uint32_t pixel_bits(float y) {
  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), 255.0f));
}

// The low bytes of px as 8 bytes, px[0] first.
__device__ __forceinline__ uint2 pack8(const uint32_t (&px)[8]) {
  uint2 r;
  r.x = __byte_perm(__byte_perm(px[0], px[1], 0x0040), __byte_perm(px[2], px[3], 0x0040), 0x5410);
  r.y = __byte_perm(__byte_perm(px[4], px[5], 0x0040), __byte_perm(px[6], px[7], 0x0040), 0x5410);
  return r;
}

// A row of 8 pixels from its t[j][v] (v = 0..7): the second pass, then
// pixel_bits<N>, packed.
template <bool N>
__device__ __forceinline__ uint2 idct_row_pixels(const float (&t)[8]) {
  float x[8];
  idct_row(t, x);
  uint32_t px[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) px[k] = pixel_bits<N>(x[k]);
  return pack8(px);
}

// A table of scales into shared memory by thread 0, at compile-time
// indices (the by-value table stays in parameter space: a thread indexes
// the scales by its row, a runtime value).
__device__ __forceinline__ void put_scales(float* sq, const Scales& q) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[i] = q.v[i];
  }
}

// Common prologue, after the scales: the input mbarrier, then a barrier.
__device__ __forceinline__ void tile_prologue(uint64_t* full) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The crossing buffer of the colour kernels and the tile inverse: value (row
// index r, column index c) of block b of a channel (the tile inverse: of a
// block row), in 32-float lines of a column pair, the pair's
// halves swapped on odd r.  A warp writing (16 blocks x c in {2i, 2i+1},
// fixed r) or reading (16 blocks x r in {2i, 2i+1}, fixed c) touches 32
// distinct banks.
__device__ __forceinline__ int cross_at(int ch, int r, int c, int b) {
  return ((ch * 8 + r) * 4 + (c >> 1)) * 32 + (((c ^ r) & 1) << 4) + b;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// the driver library); null where the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The (batch, 3, h2, w) u8 planes at `base`, rows w bytes apart, planes
// plane_stride and frames 3*plane_stride, as a tensor map whose box is 128
// columns x `rows` rows x 3 planes x 1 frame (a tile of the colour
// kernels).
inline bool planes_map(CUtensorMap* m, const void* base, int batch, int h2, int w,
                       long long plane_stride, unsigned rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h2, 3, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)w, (cuuint64_t)plane_stride,
                                 (cuuint64_t)(3 * plane_stride)};
  const cuuint32_t box[4] = {128, rows, 3, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (batch, h2, w) u8 frames at `base`, rows w bytes apart and frames
// `frame_stride`, as a tensor map whose box is `cols` columns x `rows`
// rows x 1 frame (dct32.cu, encq.cu).
inline bool view_map(CUtensorMap* m, const void* base, int batch, int h2, int w,
                     long long frame_stride, unsigned cols, unsigned rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)h2, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)w, (cuuint64_t)frame_stride};
  const cuuint32_t box[3] = {cols, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Let `fn` take `smem` dynamic shared bytes (above the 48 KB default).
inline cudaError_t allow_smem(const void* fn, int smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

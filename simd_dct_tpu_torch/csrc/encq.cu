// Enc-quant kernels for Hopper (sm_90a): encode and decode of
// simdDCT_EncodeQuantizeBuffer in its three byte layouts.  Plain C entry
// points, loaded with ctypes by simd_dct_tpu_torch/kernels/_build.py and
// wrapped by kernels/cuda_dct.py.
//
// Enc-quant: pixels of the top view times f32(1/255), 2-D DCT C = D X D^T
// per 8x8 block, q = 255 / (lut * 0.95), +127 bias, u8.  The block's 64-byte
// buffer is fx-major: byte p = v*8 + u holds C[u][v] (u vertical, v
// horizontal frequency) quantized with scale q[p] -- the LUT indexes buffer
// order, so a transposed-LUT mistake shows only with an asymmetric LUT.
// With BW = W/8 blocks per row, block n = s*BW + bx (strip s, column bx):
//   * scalar: the buffer at bytes n*64 .. n*64+63;
//   * pair (BW even): cell n/2 at bytes (n/2)*128, two 64-byte halves.  In
//     row v (8 bytes) of half h, block n%2 owns bytes n%2*4 .. +3, holding
//     the u-quad {0,1,4,5} (h = 0) or {2,3,6,7} (h = 1) of column v
//     (core/golden.py pair_cell_permutation);
//   * pair_as_written: pair with every second half zero, except that an
//     included strip s-1 followed by an excluded strip s hands the second
//     half of strip s-1's last cell to the first 64 bytes of strip s
//     (layout/reorder.py pair_as_written_masked).
//
// Design (replacing the TPU's permuted-basis matmuls and in-kernel u8
// transposes, which exist only because Mosaic cannot reshape u8 -- on this
// card the layout is index arithmetic plus one warp shuffle):
//   * one thread per 8x8 block, f32 registers, the DCT and quantizer of
//     dct_common.cuh (the same arithmetic as mode32);
//   * in every layout the output is a sequence of 64-byte units, and
//     thread n owns unit n: its scalar buffer, or for the pair layouts the
//     half n%2 of cell n/2.  The two threads of a cell swap the other half's
//     4-byte words with one __shfl_xor_sync per row, so every unit has
//     exactly one writer, the as-written spill included: the two threads of
//     an excluded strip's first cell compute the previous strip's last cell
//     and keep its halves the other way round;
//   * a CUDA block of kThreads threads owns the contiguous span of
//     kThreads units.  The span goes through shared memory, units
//     kUnitStride = 64 + 16 bytes apart: a quarter-warp's 16-byte accesses
//     to 8 units' same piece then fall in 8 disjoint bank quads.  Device
//     memory sees only 16-byte accesses, a warp on 512 contiguous bytes;
//   * grid = (ceil(blocks per frame / kThreads), batch): one launch covers a
//     (B, H, W) batch; any H2 % 8 == 0 with W % 8 == 0 (scalar) or
//     W % 16 == 0 (pair layouts) runs directly, with no pad or slice pass.

#include "dct_common.cuh"

namespace {

// kThreads (dct_common.cuh): 8x8 blocks (64-byte units) per CUDA block
constexpr int kUnitStride = 80;   // shared-memory bytes per 64-byte unit
constexpr int kPieces = kUnitStride / 16;

enum Layout { kScalarLayout = 0, kPair = 1, kPairAsWritten = 2 };

__device__ __forceinline__ bool strip_included(long long s, int start_y, int end_y,
                                               int legacy_range) {
  const long long y = legacy_range ? 8 * s : 16 * s;  // legacy: the NoSimd y test
  return y >= start_y && y <= end_y;
}

// Units [0, n) of a span between device memory (contiguous) and shared
// memory (kUnitStride apart), as 16-byte pieces.  Each round, warp wp moves
// units wp*8 .. wp*8+7; lane l moves piece l>>3 of unit wp*8 + (l&7).
__device__ __forceinline__ void span_to_shared(const uint4* __restrict__ global,
                                               uint4* __restrict__ smem, long long n) {
  const int lane = threadIdx.x & 31;
  for (int u = (threadIdx.x >> 5) * 8 + (lane & 7); u < n; u += kThreads / 4)
    smem[u * kPieces + (lane >> 3)] = __ldg(global + u * 4 + (lane >> 3));
}

__device__ __forceinline__ void span_to_global(uint4* __restrict__ global,
                                               const uint4* __restrict__ smem, long long n) {
  const int lane = threadIdx.x & 31;
  for (int u = (threadIdx.x >> 5) * 8 + (lane & 7); u < n; u += kThreads / 4)
    global[u * 4 + (lane >> 3)] = smem[u * kPieces + (lane >> 3)];
}

// Scalar words of column v (bytes u = 0..3 | 4..7) <-> pair half words
// (u = 0,1,4,5 | 2,3,6,7).  The same two selectors go both ways.
__device__ __forceinline__ uint32_t half0_of(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}
__device__ __forceinline__ uint32_t half1_of(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _encq_pair_kernel (all three
// layouts; its scalar_pi permutation matmul is the scalar branch here).
// Bound: memory, 1 byte read + 1 byte written per pixel; 16 f32 FMAs per
// pixel are below the CUDA cores' rate.
template <int R, int L>
__global__ void __launch_bounds__(kThreads)
encq_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales q, int h2,
            int w, long long frame_stride, int start_y, int end_y, int legacy_range) {
  __shared__ __align__(16) uint8_t units[kThreads * kUnitStride];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const bool valid = blk < nblk;
  long long s = valid ? blk / bw : 0;
  int bx = valid ? (int)(blk - s * bw) : 0;
  const bool inc = valid && strip_included(s, start_y, end_y, legacy_range);
  // The as-written spill: both threads of an excluded strip's first cell,
  // after an included strip, compute that strip's last cell.
  const bool spill = L == kPairAsWritten && valid && !inc && bx < 2 && s > 0 &&
                     strip_included(s - 1, start_y, end_y, legacy_range);
  if (spill) {
    s -= 1;
    bx += bw - 2;
  }
  uint32_t wd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wd[i] = 0;
  if (inc || spill) {
    float x[64];
    load_block(img + (long long)blockIdx.y * frame_stride + 8 * s * w + 8 * bx, w, x);
#pragma unroll
    for (int p = 0; p < 64; ++p) x[p] = __fmul_rn(x[p], kInv255);
    dct2d(x);  // x[u*8 + v] = C[u][v]
#pragma unroll
    for (int v = 0; v < 8; ++v) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = 4 * h + i;
          word |= (uint32_t)quantize<R>(x[u * 8 + v], q.v[v * 8 + u]) << (8 * i);
        }
        wd[v * 2 + h] = word;  // buffer bytes p = v*8 + 4h .. v*8 + 4h + 3
      }
    }
  }
  bool write = inc;
  if (L != kScalarLayout) {
    const int blkbit = threadIdx.x & 1;        // block n%2 of its cell (blk0 is even)
    const int keep = blkbit ^ (spill ? 1 : 0);  // the cell half this thread stores
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const uint32_t h0 = half0_of(wd[2 * v], wd[2 * v + 1]);
      const uint32_t h1 = half1_of(wd[2 * v], wd[2 * v + 1]);
      const uint32_t own = keep ? h1 : h0;
      const uint32_t other = __shfl_xor_sync(0xffffffffu, keep ? h0 : h1, 1);
      // selects, not wd[2*v + blkbit]: a runtime index puts wd in local memory
      wd[2 * v] = blkbit ? other : own;
      wd[2 * v + 1] = blkbit ? own : other;
    }
    if (L == kPairAsWritten) write = keep ? spill : inc;
  }
  if (!write) {
#pragma unroll
    for (int i = 0; i < 16; ++i) wd[i] = 0;
  }
  uint4* mine = reinterpret_cast<uint4*>(units + threadIdx.x * kUnitStride);
#pragma unroll
  for (int k = 0; k < 4; ++k) mine[k] = make_uint4(wd[4 * k], wd[4 * k + 1], wd[4 * k + 2], wd[4 * k + 3]);
  __syncthreads();
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  span_to_global(reinterpret_cast<uint4*>(out + (long long)blockIdx.y * h2 * w + blk0 * 64),
                 reinterpret_cast<const uint4*>(units), nvalid);
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _decq_pair_kernel (scalar and
// pair records).  Bound: memory, as encq.  Design: the inverse of encq --
// the span comes in with 16-byte loads, thread n takes unit n, and for the
// pair layout the two threads of a cell swap the words of each other's
// block.  Dequantize (b - 127) * qi, IDCT, *255, rint, clip, u8.
template <int L>
__global__ void __launch_bounds__(kThreads)
decq_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out, Scales qi, int h2,
            int w) {
  __shared__ __align__(16) uint8_t units[kThreads * kUnitStride];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const long long frame = (long long)blockIdx.y * h2 * w;
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  span_to_shared(reinterpret_cast<const uint4*>(records + frame + blk0 * 64),
                 reinterpret_cast<uint4*>(units), nvalid);
  __syncthreads();
  uint32_t wd[16];
  const uint4* mine = reinterpret_cast<const uint4*>(units + threadIdx.x * kUnitStride);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = mine[k];  // beyond nvalid: stale bytes, never stored
    wd[4 * k] = v.x;
    wd[4 * k + 1] = v.y;
    wd[4 * k + 2] = v.z;
    wd[4 * k + 3] = v.w;
  }
  if (L == kPair) {
    const int blkbit = threadIdx.x & 1;  // also the cell half in this unit
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const uint32_t own = blkbit ? wd[2 * v + 1] : wd[2 * v];
      const uint32_t other = __shfl_xor_sync(0xffffffffu, blkbit ? wd[2 * v] : wd[2 * v + 1], 1);
      const uint32_t h0 = blkbit ? other : own;
      const uint32_t h1 = blkbit ? own : other;
      wd[2 * v] = half0_of(h0, h1);
      wd[2 * v + 1] = half1_of(h0, h1);
    }
  }
  if (blk >= nblk) return;
  float c[64];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint32_t b = (wd[v * 2 + (u >> 2)] >> (8 * (u & 3))) & 0xffu;
      c[u * 8 + v] = __fmul_rn((float)b - 127.0f, qi.v[v * 8 + u]);
    }
  }
  idct2d(c);
#pragma unroll
  for (int p = 0; p < 64; ++p) c[p] = __fmul_rn(c[p], 255.0f);
  const long long s = blk / bw;
  const int bx = (int)(blk - s * bw);
  store_block(out + frame + 8 * s * w + 8 * bx, w, c);
}

bool geometry_ok(int batch, int h2, int w, int layout) {
  const int wmul = layout == kScalarLayout ? 8 : 16;
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 8 == 0 && w % wmul == 0;
}

unsigned grid_x(int h2, int w) {
  const long long nblk = (long long)(h2 / 8) * (w / 8);
  return (unsigned)((nblk + kThreads - 1) / kThreads);
}

template <int R>
int launch_encq(int layout, dim3 grid, cudaStream_t st, const uint8_t* in, uint8_t* o,
                const Scales& s, int h2, int w, long long frame_stride, int start_y, int end_y,
                int legacy_range) {
  switch (layout) {
    case kScalarLayout:
      encq_kernel<R, kScalarLayout><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride,
                                                                start_y, end_y, legacy_range);
      break;
    case kPair:
      encq_kernel<R, kPair><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y,
                                                        end_y, legacy_range);
      break;
    case kPairAsWritten:
      encq_kernel<R, kPairAsWritten><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride,
                                                                 start_y, end_y, legacy_range);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8.  q: 64 host f32 in buffer
// order.  layout: 0 scalar, 1 pair, 2 pair_as_written.
int sdct_encq(const void* img, void* out, const float* q, int batch, int h2, int w,
              long long frame_stride, int start_y, int end_y, int legacy_range, int rounding,
              int layout, void* stream) {
  if (!geometry_ok(batch, h2, w, layout)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(q);
  switch (rounding) {
    case kRne:
      return launch_encq<kRne>(layout, grid, st, in, o, s, h2, w, frame_stride, start_y, end_y,
                               legacy_range);
    case kScalar:
      return launch_encq<kScalar>(layout, grid, st, in, o, s, h2, w, frame_stride, start_y,
                                  end_y, legacy_range);
    case kClampFirst:
      return launch_encq<kClampFirst>(layout, grid, st, in, o, s, h2, w, frame_stride, start_y,
                                      end_y, legacy_range);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// records: (batch, h2*w) u8, layout 0 scalar or 1 pair.  out: (batch, h2, w)
// u8.  qi: 64 host f32 in buffer order.
int sdct_decq(const void* records, void* out, const float* qi, int batch, int h2, int w,
              int layout, void* stream) {
  if (!geometry_ok(batch, h2, w, layout)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const Scales s = to_scales(qi);
  switch (layout) {
    case kScalarLayout:
      decq_kernel<kScalarLayout><<<grid, kThreads, 0, st>>>((const uint8_t*)records,
                                                            (uint8_t*)out, s, h2, w);
      break;
    case kPair:
      decq_kernel<kPair><<<grid, kThreads, 0, st>>>((const uint8_t*)records, (uint8_t*)out, s,
                                                    h2, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

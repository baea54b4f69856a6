// Mode32 kernels for Hopper (sm_90a): encode, decode, fused round trip, and
// the tier probe.  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by kernels/cuda_dct.py.
//
// Mode32 (simdDCT_EncodeQuantize32ReorderBuffer): raw 0..255 pixels of the
// top view, 2-D DCT C = D X D^T per 8x8 block, q = 255 / (lut * 0.95),
// +127 bias, u8.  Each group of 8 horizontally adjacent blocks of a strip
// stores one 512-byte coefficient-major record: byte p*8 + b is coefficient
// p = u*8 + v of block b.  Records are laid out strip by strip, group by
// group, so for a frame with BW = W/8 blocks per row the record of block
// number n = s*BW + bx (strip s, block column bx) starts at byte
// (n/8)*512 and its coefficient p sits at (n/8)*512 + p*8 + n%8.
//
// Design of the encode and the decode (replacing the TPU's (128,128)
// permuted-basis matmuls, which existed only because Mosaic cannot reshape
// u8 -- on this card the record permutation is index arithmetic):
//   * one thread per 8x8 block holds its 64 values in f32 registers and runs
//     the two 8-term passes against D in __constant__ memory;
//   * 8 consecutive threads are one 8-block group; a CUDA block of kThreads
//     threads covers kThreads consecutive block numbers, which own one
//     contiguous span of kThreads*64 record bytes.  That span goes through
//     shared memory, so records are read and written with 16-byte accesses.
//     Groups sit kGroupStride = 512 + 16 bytes apart there: the four groups
//     of a warp then hit different banks on the stride-8 record bytes
//     (measured on an H100: dec32 about 5% faster than a 512-byte stride);
//   * pixel rows are read and written as 8-byte accesses, neighbouring
//     threads on neighbouring addresses;
//   * grid = (ceil(blocks per frame / kThreads), batch): one launch covers
//     a whole (B, H, W) batch, and any W % 64 == 0, H2 % 8 == 0 geometry
//     runs directly (no pad or slice pass).
// The fused round trip (roundtrip32_kernel): strip tiles, a persistent grid.
//   * A tile is kRtTileBlocks = 16 blocks of each of kRtTileStrips = 2
//     strips: 16 rows x 128 pixels, in by one 3-D tensor copy over the
//     image read as (W, H2, B) with its row and frame strides (only the
//     first H2 rows of each frame), out by one 3-D tensor store over (W, H2,
//     B).  The last tile of a row of tiles is short where W % 128 == 64, the
//     last row where H2 % 16 == 8: the copy fills zeros past the edge and
//     the store drops them.
//   * kRtWarps = 2 warps a CTA, each walking its own tiles (worker
//     blockIdx.x * kRtWarps + warp takes every (grid * kRtWarps)-th tile,
//     numbered over frame, row of tiles and tile of the row) with its own
//     kRtStages input tiles in flight, each on its own mbarrier, the next
//     brought in as soon as the warp has read a tile, and its own
//     kRtOutBuffers pixel buffers, each reused after
//     cp.async.bulk.wait_group.read; the warp's own sync is the only
//     barrier.
//   * One thread an 8x8 block, kept whole in registers (80 of them): a
//     lane reads its block's 8 rows as 8-byte words (a half warp's 16
//     blocks are one 128-byte line), takes each byte to f32 exactly
//     (byte_f32), and runs dct2d, the quantizer and idct2d with no crossing:
//     the basis is compiled into the FMAs (tile_common.cuh basis), the
//     scales come from parameter space at constant indices.  Then it rounds
//     half to even, clips and packs each row into the pixel buffer.
//   * A tile of 2,048 pixels is a warp's work: 3,840 tiles at 4K against
//     the 3,168 warps the card holds, so the last round runs a fifth full.
//     The crossed form (roundtrip32_rgb_kernel's without the mix: eight
//     threads a block, one strip of 16 or 32 blocks a tile, three crossings
//     through shared memory and six barriers a tile) takes 7,680 smaller
//     tiles but more instructions a pixel (this loop is 2,961 a thread, 46
//     a pixel), and ran 5-6% slower (tiles_variants.py builds it, PERF.md).
//   * The quantize step is clip(rint(z*q), -127, 128) (pallas_dct.py:422)
//     computed as rint(clip(z*q)) by x + 1.5*2^23 (ties to even; the limits
//     are integers), then times the dequant scale; pixels round the same
//     way on the clipped value.  Every product and sum of dct2d and idct2d
//     is kept in its order and every conversion is exact, so the round trip
//     equals dec32(enc32(x)) byte for byte.
// Arithmetic is f32 on the CUDA cores, in the device functions of
// dct_common.cuh and tile_common.cuh (shared with the other sources).

#include "tile_common.cuh"

namespace {

// kThreads (16 groups), kGroupStride and smem_piece: dct_common.cuh
constexpr int kRecSmem = (kThreads / 8) * kGroupStride;

// Replaces simd_dct_tpu/kernels/pallas_dct.py _enc32_kernel.
// Bound: memory, 1 byte read + 1 byte written per pixel; 16 f32 FMAs per
// pixel are far below the CUDA cores' rate.  Design: records are staged in
// shared memory and leave in 16-byte stores, so the coefficient-major
// scatter costs no extra device-memory traffic.
template <int R>
__global__ void __launch_bounds__(kThreads)
enc32_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
             Scales q, int h2, int w, long long frame_stride, int start_y,
             int end_y) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const uint8_t* src = img + (long long)blockIdx.y * frame_stride;
  uint8_t* dst = out + (long long)blockIdx.y * h2 * w;
  uint8_t* slot = rec + (threadIdx.x >> 3) * kGroupStride + (threadIdx.x & 7);
  if (blk < nblk) {
    const long long s = blk / bw;
    const int bx = (int)(blk - s * bw);
    const long long y2 = 16 * s;
    if (y2 >= start_y && y2 <= end_y) {
      float x[64];
      load_block(src + 8 * s * w + 8 * bx, w, x);
      dct2d(x);
#pragma unroll
      for (int p = 0; p < 64; ++p) slot[p * 8] = quantize<R>(x[p], q.v[p]);
    } else {
#pragma unroll
      for (int p = 0; p < 64; ++p) slot[p * 8] = 0;
    }
  }
  __syncthreads();
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(rec);
  uint4* d4 = reinterpret_cast<uint4*>(dst + blk0 * 64);
  for (int i = threadIdx.x; i < nvalid * 4; i += kThreads) d4[i] = s4[smem_piece(i)];
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _dec32_kernel.
// Bound: memory, as enc32.  Design: the CUDA block's contiguous record
// span is loaded with 16-byte loads into shared memory; each thread then
// gathers its block's 64 bytes at stride 8 from there.
__global__ void __launch_bounds__(kThreads)
dec32_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out,
             Scales qi, int h2, int w) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const long long frame = (long long)blockIdx.y * h2 * w;
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(records + frame + blk0 * 64);
  uint4* d4 = reinterpret_cast<uint4*>(rec);
  for (int i = threadIdx.x; i < nvalid * 4; i += kThreads) d4[smem_piece(i)] = __ldg(s4 + i);
  __syncthreads();
  if (blk >= nblk) return;
  const uint8_t* slot = rec + (threadIdx.x >> 3) * kGroupStride + (threadIdx.x & 7);
  float c[64];
#pragma unroll
  for (int p = 0; p < 64; ++p) c[p] = __fmul_rn((float)slot[p * 8] - 127.0f, qi.v[p]);
  idct2d(c);
  const long long s = blk / bw;
  const int bx = (int)(blk - s * bw);
  store_block(out + frame + 8 * s * w + 8 * bx, w, c);
}

// -- the fused round trip: strip tiles ---------------------------------------

// The strips a tile spans and its blocks of each (a warp's 32 blocks), the
// warps of a CTA (each walks its own tiles with its own buffers), a warp's
// input tiles in flight and its pixel buffers.
constexpr int kRtTileStrips = 2;
constexpr int kRtTileBlocks = 16;
constexpr int kRtWarps = 2;
constexpr int kRtStages = 2;
constexpr int kRtOutBuffers = 2;
constexpr int kRtRow = 8 * kRtTileBlocks;                 // pixels a tile row
constexpr int kRtTileBytes = 8 * kRtTileStrips * kRtRow;  // its pixel rows
constexpr int kRtThreads = 32 * kRtWarps;
// CTAs an SM the kernel is built for: 24 warps at its 80 registers; the
// hint ran 3.5% faster at 4K than none, with the same count
// (tiles_variants.py, PERF.md)
constexpr int kRtCtas = 24 / kRtWarps;
static_assert(kRtTileStrips * kRtTileBlocks == 32, "a warp a tile");
// Shared bytes of a launch: each warp's input tiles and pixel buffers.  The
// host's plan (cuda_dct.roundtrip32_smem) computes the same and the entry
// point compares.
constexpr int kRtSmem = kRtWarps * (kRtStages + kRtOutBuffers) * kRtTileBytes;

struct RtGeom {
  unsigned tpr;     // tiles a row of tiles (across the width)
  unsigned rows;    // rows of tiles a frame: strips / kRtTileStrips, rounded up
  unsigned tiles;   // of the launch (the host keeps it below 2^31)
};

struct RtTile {
  int frame;
  int y0, x0;  // first pixel row and column
};

// Tile t, numbered over (frame, row of tiles, tile of the row).
__device__ __forceinline__ RtTile rt_at(const RtGeom& g, unsigned t) {
  const unsigned fr = t / g.tpr, x = t - fr * g.tpr;
  const unsigned frame = fr / g.rows;
  RtTile a;
  a.frame = (int)frame;
  a.y0 = (int)(fr - frame * g.rows) * 8 * kRtTileStrips;
  a.x0 = (int)x * kRtRow;
  return a;
}

// One thread: tile t (if the launch has it) into `stage` by one 3-D tensor
// copy, completing on `bar` with the whole box (a short tile's columns past
// W, or rows past H2, come in as zeros).
__device__ __forceinline__ void rt_load(const CUtensorMap* m, const RtGeom& g, unsigned t,
                                        uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const RtTile a = rt_at(g, t);
  arrive_expect(bar, kRtTileBytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(saddr(stage)),
      "l"(m), "r"(a.x0), "r"(a.y0), "r"(a.frame), "r"(saddr(bar))
      : "memory");
}

// The storing thread: tile t's pixel rows by one 3-D tensor store (columns
// past W and rows past H2 are not written).
__device__ __forceinline__ void rt_store(const CUtensorMap* m, const RtGeom& g, unsigned t,
                                         const uint8_t* pix) {
  const RtTile a = rt_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          m),
      "r"(a.x0), "r"(a.y0), "r"(a.frame), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The quantized level of z at scale q, dequantized at qi:
// clip(rint(z*q), -127, 128) * qi, as rint(clip(z*q)) (the limits are
// integers) off the conversion unit.
__device__ __forceinline__ float requant(float z, float q, float qi) {
  return __fmul_rn(rint_small(fminf(fmaxf(__fmul_rn(z, q), -127.0f), 128.0f)), qi);
}

// Warp w of the CTA is worker blockIdx.x * kRtWarps + w and takes every
// (grid * kRtWarps)-th tile; lane l holds block l % 16 of strip l / 16 of a
// tile: its 64 values in registers through dct2d, the quantizer
// and idct2d, every product and sum in order (dct_column, dct_row,
// idct_column, idct_row), the scales from parameter space at constant
// indices.
__device__ __forceinline__ void roundtrip_whole(const Scales& q, const Scales& qi,
                                                const RtGeom& g, const CUtensorMap* tin,
                                                const CUtensorMap* tout, uint8_t* smem,
                                                uint64_t (&bars)[kRtStages]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* stages = smem + warp * (kRtStages + kRtOutBuffers) * kRtTileBytes;
  uint8_t* outs = stages + kRtStages * kRtTileBytes;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kRtStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const unsigned worker = blockIdx.x * kRtWarps + warp, workers = gridDim.x * kRtWarps;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kRtStages; ++s)
      rt_load(tin, g, worker + s * workers, stages + s * kRtTileBytes, &bars[s]);
  }
  unsigned i = 0;  // the worker's tile count
  for (unsigned t = worker; t < g.tiles; t += workers, ++i) {
    const unsigned s = i % kRtStages;
    wait_full(&bars[s], (i / kRtStages) & 1);
    float x[64];
    // the block's first byte: block lane % kRtTileBlocks of strip lane / kRtTileBlocks
    const int at = 8 * (lane / kRtTileBlocks) * kRtRow + 8 * (lane % kRtTileBlocks);
    const uint8_t* in = stages + s * kRtTileBytes + at;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint2 p = *reinterpret_cast<const uint2*>(in + r * kRtRow);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[r * 8 + c] = byte_f32(p.x, c);
        x[r * 8 + 4 + c] = byte_f32(p.y, c);
      }
    }
    __syncwarp();
    // the tile is read: the one kRtStages ahead comes into its buffer
    if (lane == 0) rt_load(tin, g, t + kRtStages * workers, stages + s * kRtTileBytes, &bars[s]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // t[u][k] = sum_j D[u][j] x[j][k]
      float col[8], tc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) col[j] = x[j * 8 + k];
      dct_column(col, tc);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u * 8 + k] = tc[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {  // c[u][v] = sum_k t[u][k] D[v][k], requantized
      float row[8], c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = x[u * 8 + k];
      dct_row(row, c);
#pragma unroll
      for (int v = 0; v < 8; ++v) x[u * 8 + v] = requant(c[v], q.v[u * 8 + v], qi.v[u * 8 + v]);
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {  // t[j][v] = sum_u D[u][j] c[u][v]
      float col[8], tt[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) col[u] = x[u * 8 + v];
      idct_column(col, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j * 8 + v] = tt[j];
    }
    uint8_t* o = outs + (i % kRtOutBuffers) * kRtTileBytes;
    // the store of the tile kRtOutBuffers back has read this buffer
    if (lane == 0) bulk_wait_read<kRtOutBuffers - 1>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // x[j][k] = sum_v t[j][v] D[v][k], rounded and packed
      float row[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) row[v] = x[j * 8 + v];
      *reinterpret_cast<uint2*>(o + at + j * kRtRow) = idct_row_pixels<false>(row);
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) rt_store(tout, g, t, o);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _roundtrip_kernel.
// Bound: memory, 2 bytes a pixel as enc32; the matrix form that fused ==
// decode(encode) fixes sets an arithmetic floor above it (PERF.md).
// Design: see the head of this file.
__global__ void __launch_bounds__(kRtThreads, kRtCtas)
roundtrip32_kernel(const __grid_constant__ Scales q, const __grid_constant__ Scales qi, RtGeom g,
                   const __grid_constant__ CUtensorMap tin,
                   const __grid_constant__ CUtensorMap tout) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kRtWarps][kRtStages];
  roundtrip_whole(q, qi, g, &tin, &tout, smem, full[threadIdx.x >> 5]);
}

// Replaces simd_dct_tpu/dispatch/capability.py _pallas_functional.k, the
// trial kernel of the tier probe: u8 load, +1 in int32, clip, u8 store.
__global__ void probe_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int v = (int)in[i] + 1;
    out[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

unsigned grid_x(int h2, int w) {
  const long long nblk = (long long)(h2 / 8) * (w / 8);
  return (unsigned)((nblk + kThreads - 1) / kThreads);
}

// The round trip's tensor maps: the input (batch frames of h2 rows read
// from frames frame_stride bytes apart) and the output as (W, h2, batch),
// both with the box of a tile: kRtRow columns x 8 * kRtTileStrips rows x 1
// frame.
bool rt_maps(CUtensorMap* tin, CUtensorMap* tout, const void* img, void* out, int batch, int h2,
             int w, long long frame_stride) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)h2, (cuuint64_t)batch};
  const cuuint64_t in_strides[2] = {(cuuint64_t)w, (cuuint64_t)frame_stride};
  const cuuint64_t out_strides[2] = {(cuuint64_t)w, (cuuint64_t)h2 * w};
  const cuuint32_t box[3] = {kRtRow, 8 * kRtTileStrips, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(tin, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(img), dims, in_strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(tout, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, out, dims, out_strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8 records.  q: 64 host f32.
int sdct_enc32(const void* img, void* out, const float* q, int batch, int h2, int w,
               long long frame_stride, int start_y, int end_y, int rounding,
               void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(q);
  switch (rounding) {
    case kRne:
      enc32_kernel<kRne><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y, end_y);
      break;
    case kScalar:
      enc32_kernel<kScalar><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y, end_y);
      break;
    case kClampFirst:
      enc32_kernel<kClampFirst><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y,
                                                          end_y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// records: (batch, h2*w) u8.  out: (batch, h2, w) u8.  qi: 64 host f32.
int sdct_dec32(const void* records, void* out, const float* qi, int batch, int h2, int w,
               void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  dec32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)records, (uint8_t*)out, to_scales(qi), h2, w);
  return (int)cudaGetLastError();
}

// The launch of the round trip: the shared bytes a CTA takes, how many such
// CTAs an SM holds and the SMs of the current card; a tile's blocks of each
// strip and its strips, and the tiles a CTA works on at once.
int sdct_roundtrip32_capacity(int* smem, int* per_sm, int* sms, int* tile_blocks,
                              int* tile_strips, int* workers) {
  *smem = kRtSmem;
  *tile_blocks = kRtTileBlocks;
  *tile_strips = kRtTileStrips;
  *workers = kRtWarps;
  const void* fn = (const void*)roundtrip32_kernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kRtThreads, *smem);
  return (int)e;
}

// img as for sdct_enc32, 16-byte aligned, frame_stride a multiple of 16;
// out: (batch, h2, w) u8, 16-byte aligned.  grid and smem: the host's
// launch plan (cuda_dct.roundtrip32_plan); smem must equal what the kernel
// lays out.
int sdct_roundtrip32(const void* img, void* out, const float* q, const float* qi, int batch,
                     int h2, int w, long long frame_stride, int grid, int smem, void* stream) {
  if (!mode32_geometry_ok(batch, h2, w) || grid <= 0 || smem != kRtSmem ||
      frame_stride < (long long)h2 * w || (((uintptr_t)img | (uintptr_t)out | frame_stride) & 15))
    return (int)cudaErrorInvalidValue;
  const long long tpr = (w / 8 + kRtTileBlocks - 1) / kRtTileBlocks;
  const long long rows = (h2 / 8 + kRtTileStrips - 1) / kRtTileStrips;
  const long long tiles = (long long)batch * rows * tpr;
  if (tiles >= (1ll << 31) || grid > (tiles + kRtWarps - 1) / kRtWarps)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tin = {}, tout = {};
  if (!rt_maps(&tin, &tout, img, out, batch, h2, w, frame_stride))
    return (int)cudaErrorInvalidValue;
  RtGeom g;
  g.tpr = (unsigned)tpr;
  g.rows = (unsigned)rows;
  g.tiles = (unsigned)tiles;
  Scales sq = to_scales(q), sqi = to_scales(qi);
  void* args[] = {&sq, &sqi, &g, &tin, &tout};
  return (int)cudaLaunchKernel((const void*)roundtrip32_kernel, dim3(grid), dim3(kRtThreads), args,
                               (size_t)smem, (cudaStream_t)stream);
}

int sdct_probe(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const uint8_t*)in,
                                                                 (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* sdct_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

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
// The encode and the decode (enc32_kernel, dec32_kernel): strip tiles, a
// persistent grid (the form of encq.cu on mode32's records; they replace
// the TPU's (128,128) permuted-basis matmuls, which existed only because
// Mosaic cannot reshape u8 -- on this card the record permutation is index
// arithmetic).
//   * A tile is kM32TileBlocks = nb = 32 consecutive blocks of one strip of
//     one frame: 8 pixel rows of 8nb bytes and nb/8 whole groups (W % 64 ==
//     0), whose records are the 64nb consecutive bytes at 64*(s*BW + bx0)
//     of the frame's records.  Tiles never cross a strip; the last of a
//     strip is short where nb does not divide BW (1080p: 240 blocks end in
//     a tile of 16).  CTA i takes tiles i, i + grid, ..., numbered over
//     (frame, strip, tile of the strip), walked without divisions
//     (tile_common.cuh TileWalk).
//   * Pixels move by tensor copies only: the wrappers take 16-byte aligned
//     frames, and W % 64 == 0 keeps every row and frame stride a multiple
//     of 16.  One thread brings a tile in by one 3-D tensor copy of the
//     view read as (W, H2, B) with the frame stride (only the first H2 rows
//     of each frame), on an mbarrier, and the CTA's next kept tile as soon
//     as this one's pixels are read; the decode's pixel rows leave by one
//     tensor store a tile, from two alternating buffers.
//     cuda_dct.enc32_plan / dec32_plan give the grid.
//   * Records move by 1-D bulk copies, a 512-byte group each, into and out
//     of padded groups in shared memory, kGroupStride = 512 + 16 bytes
//     apart: a warp's byte accesses at stride 8 (32 blocks, one
//     coefficient) then fall on 8 distinct banks.  The encode stages a tile
//     in one of two alternating buffers; the decode brings the next tile's
//     records in as soon as this one's are read.
//   * Encode: kM32BlockThreads = 2 threads a block.  A thread reads
//     kM32Lines columns of its block (each byte once, exactly to f32 off
//     the conversion unit; mode32 is raw: no 1/255) and runs dct2d's column
//     pass; t[u][k] crosses through shared memory (tile_common.cuh
//     enc_cross) to the thread of rows u, which runs the row pass and
//     quantizes (dct_column, dct_row, quantize_byte: rne's +127 added to the
//     integer bits after the rounding), storing byte (u*8+v)*8 + (b & 7) of
//     its block's group.  Strip s is kept iff start_y <= 16*s <= end_y; an
//     excluded strip loads nothing and its tiles store zeros by the
//     threads' 16-byte stores: every output byte has one writer.
//   * Decode, the mirror: the thread of coefficient column v reads its 8
//     bytes at stride 64 out of the staged group, dequantizes ((b - 127)
//     exactly, times the scale) and runs idct2d's first pass; the thread of
//     rows j the second, rounds half to even, clips and packs 8 pixels
//     (tile_common.cuh dequant_byte, dec_cross, idct_row_pixels).  The DCT
//     basis is compiled into the FMAs as immediates (tile_common.cuh
//     basis), never read from kD.
//   * Every product and sum of dct2d / idct2d and of the quantizer is kept
//     in its order and every conversion is exact, so the bytes equal the
//     thread-per-block form that dct_common.cuh's dct2d, quantize<R> and
//     idct2d give, and the fused round trip below equals dec32(enc32(x)).
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

// -- the encode and the decode: strip tiles ----------------------------------

constexpr int kM32TileBlocks = 32;                   // nb: blocks of one strip a tile
constexpr int kM32BlockThreads = 2;                  // threads an 8x8 block
constexpr int kM32Lines = 8 / kM32BlockThreads;      // columns, then rows, a thread
constexpr int kM32Threads = kM32BlockThreads * kM32TileBlocks;
constexpr int kM32RowBytes = 8 * kM32TileBlocks;     // a pixel row of a tile
constexpr int kM32TileBytes = 64 * kM32TileBlocks;   // its 8 pixel rows
constexpr int kM32Groups = kM32TileBlocks / 8;       // its 512-byte group records
constexpr int kM32RecBytes = kM32Groups * kGroupStride;  // staged, padded
constexpr int kM32CrossBytes = 4 * 64 * kM32TileBlocks;
constexpr int kE32Stages = 1;                        // the encode's pixel tiles in flight
constexpr int kE32OutBuffers = 2;                    // its record buffers
constexpr int kD32Stages = 1;                        // the decode's record tiles in flight
constexpr int kD32OutBuffers = 2;                    // its pixel buffers
static_assert(kM32TileBlocks % 8 == 0 && kM32TileBlocks <= 32,
              "whole groups; a tensor box holds at most 256 columns");
static_assert(kM32Lines == 2 || kM32Lines == 4, "2 or 4 threads a block");
// Shared bytes of a launch: the scales, the pixel tiles, the record
// buffers, the f32 crossing buffer.  The host's plan (cuda_dct.enc32_smem,
// dec32_smem) computes the same and the entry points compare.
constexpr int kE32Smem =
    64 * 4 + kE32Stages * kM32TileBytes + kE32OutBuffers * kM32RecBytes + kM32CrossBytes;
constexpr int kD32Smem =
    64 * 4 + kD32OutBuffers * kM32TileBytes + kD32Stages * kM32RecBytes + kM32CrossBytes;
static_assert(kE32Smem <= 48 * 1024 && kD32Smem <= 48 * 1024, "no opt-in attribute needed");

struct M32Geom {
  int bw;               // blocks a strip row
  int s_n;              // strips a frame: H2 / 8
  unsigned tps;         // tiles a strip
  unsigned tiles;       // of the launch (the host keeps it below 2^31)
  long long frame_rec;  // record bytes a frame: H2 * W
  int start_y, end_y;   // the encode's strip range
};

struct M32Tile {
  long long rec;  // its first record byte, from the launch's records
  int frame, s;
  int bx0, n;     // first block of the strip, blocks (multiples of 8)
  bool inc;       // its strip is kept
};

// The tiles are numbered over (frame, strip, tile of the strip): a TileWalk
// whose rows are a frame's strips.
typedef TileWalk<kM32TileBlocks> M32Walk;

__device__ __forceinline__ M32Walk m32_walk(const M32Geom& g) {
  return M32Walk(blockIdx.x, gridDim.x, g.tps, g.s_n);
}

__device__ __forceinline__ M32Tile m32_tile(const M32Geom& g, const M32Walk& w) {
  M32Tile a;
  a.frame = (int)w.f;
  a.s = (int)w.r;
  a.bx0 = w.bx0();
  a.n = w.blocks(g.bw);
  a.rec = (long long)w.f * g.frame_rec + 64LL * ((long long)a.s * g.bw + a.bx0);
  const long long y = 16LL * a.s;
  a.inc = y >= g.start_y && y <= g.end_y;
  return a;
}

// Thread 0's walk ahead of its CTA's tiles, for the loads: tiles t, t +
// grid, ... in the CTA's order.
struct M32Ahead {
  M32Walk walk;
  unsigned t;

  __device__ __forceinline__ M32Ahead(const M32Geom& g) : walk(m32_walk(g)), t(blockIdx.x) {}

  // The next tile (the encode: the next whose strip is kept; false: none
  // is left), and past it.
  __device__ __forceinline__ bool next(const M32Geom& g, bool kept_only, M32Tile& a) {
    while (t < g.tiles) {
      a = m32_tile(g, walk);
      walk.advance(g.tps, g.s_n);
      t += gridDim.x;
      if (a.inc || !kept_only) return true;
    }
    return false;
  }
};

// One thread: tile a's pixel rows into `stage` by one 3-D tensor copy,
// completing on `bar` with the whole box (a short tile's columns past W
// come in as zeros).
__device__ __forceinline__ void load_pixels(const CUtensorMap* m, const M32Tile& a,
                                            uint8_t* stage, uint64_t* bar) {
  tensor_load_3d(m, 8 * a.bx0, 8 * a.s, a.frame, stage, bar, kM32TileBytes);
}

// The storing thread: tile a's pixel rows by one 3-D tensor store (columns
// past W are not written).
__device__ __forceinline__ void store_pixels(const CUtensorMap* m, const M32Tile& a,
                                             const uint8_t* pix) {
  tensor_store_3d(m, 8 * a.bx0, 8 * a.s, a.frame, pix);
}

// One thread: tile a's records, a 512-byte group at a time, into padded
// groups at `stage`, completing on `bar`.
__device__ __forceinline__ void load_records(const uint8_t* records, const M32Tile& a,
                                             uint8_t* stage, uint64_t* bar) {
  arrive_expect(bar, 64u * a.n);
  for (int gi = 0; gi < a.n / 8; ++gi)
    bulk_load(stage + gi * kGroupStride, records + a.rec + 512 * gi, 512, bar);
}

// The storing thread: tile a's records out of the padded groups at `rec`,
// a 512-byte bulk store a group, as one bulk group.
__device__ __forceinline__ void store_records(uint8_t* out, const M32Tile& a, const uint8_t* rec) {
  for (int gi = 0; gi < a.n / 8; ++gi)
    bulk_store(out + a.rec + 512 * gi, rec + gi * kGroupStride, 512);
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _enc32_kernel.
// Bound: memory, 1 byte read + 1 byte written per pixel; the matrix form
// the bytes fix sets an arithmetic floor above it (PERF.md).  Design: see
// the head of this file.
template <int R>
__global__ void __launch_bounds__(kM32Threads)
enc32_kernel(uint8_t* __restrict__ out, const __grid_constant__ Scales q, M32Geom g,
             const __grid_constant__ CUtensorMap tin) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kE32Stages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[u*8 + v]: row u's scales
  uint8_t* stages = smem + 64 * 4;             // 128-byte aligned, as the tensor copies want
  uint8_t* recs = stages + kE32Stages * kM32TileBytes;
  float* cross = reinterpret_cast<float*>(recs + kE32OutBuffers * kM32RecBytes);
  // kM32Lines columns from kM32Lines*cq of block cb; then rows from
  // kM32Lines*grp of block b
  const int cb = threadIdx.x / kM32BlockThreads, cq = threadIdx.x % kM32BlockThreads;
  const int b = threadIdx.x % kM32TileBlocks, grp = threadIdx.x / kM32TileBlocks;
  const bool storer = threadIdx.x == kM32Threads - 1;
  // thread 0 brings the CTA's first kept tiles in before the scales go to
  // shared memory
  M32Ahead ahead(g);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kE32Stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    M32Tile n;
#pragma unroll
    for (int s = 0; s < kE32Stages; ++s)
      if (ahead.next(g, true, n)) load_pixels(&tin, n, stages + s * kM32TileBytes, &full[s]);
  }
  for (int i = threadIdx.x; i < 64; i += kM32Threads) sq[i] = q.v[i];
  __syncthreads();
  M32Walk walk = m32_walk(g);
  // this block's byte of coefficient (0, 0) in a staged group
  const int slot = (b >> 3) * kGroupStride + (b & 7);
  unsigned kept = 0, half = 0;  // the CTA's kept tiles so far; the record buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const M32Tile a = m32_tile(g, walk);
    const unsigned s = kept % kE32Stages;
    uint8_t* stage = stages + s * kM32TileBytes;
    if (a.inc) {
      wait_full(&full[s], (kept / kE32Stages) & 1);
      // columns k = kM32Lines*cq + h of block cb: t[u][k] = sum_j D[u][j] x[j][k]
      float x[kM32Lines][8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint8_t* p = stage + r * kM32RowBytes + cb * 8 + kM32Lines * cq;
        const uint32_t bytes = kM32Lines == 4 ? *reinterpret_cast<const uint32_t*>(p)
                                              : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
        for (int h = 0; h < kM32Lines; ++h) x[h][r] = byte_f32(bytes, h);
      }
      float tc[kM32Lines][8];
#pragma unroll
      for (int h = 0; h < kM32Lines; ++h) dct_column(x[h], tc[h]);
#pragma unroll
      for (int uu = 0; uu < 8; ++uu) {
        float* dst = cross + enc_cross(uu, kM32Lines * cq, cb, kM32TileBlocks);
        if (kM32Lines == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(tc[0][uu], tc[1][uu],
                                                        tc[2 % kM32Lines][uu], tc[3 % kM32Lines][uu]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(tc[0][uu], tc[1][uu]);
      }
    }
    walk.advance(g.tps, g.s_n);
    // the store of the kept tile kE32OutBuffers back has read its buffer
    if (storer) bulk_wait_read<kE32OutBuffers - 1>();
    __syncthreads();
    // the pixels are read: the CTA's kept tile kE32Stages ahead comes in
    // under the rows
    if (threadIdx.x == 0 && a.inc) {
      M32Tile n;
      if (ahead.next(g, true, n)) load_pixels(&tin, n, stage, &full[s]);
    }
    uint8_t* rec = recs + half * kM32RecBytes;
    if (a.inc) {
      // rows u of block b: c[u][v] = sum_k t[u][k] D[v][k], quantized into
      // byte (u*8 + v)*8 + (b & 7) of its group
      const int lo = ((b >> 2) & 1) << 2;
#pragma unroll
      for (int i = 0; i < kM32Lines; ++i) {
        const int u = kM32Lines * grp + i;
        const float* line = cross + u * 8 * kM32TileBlocks + b * 8;
        const float4 t0 = *reinterpret_cast<const float4*>(line + lo);
        const float4 t1 = *reinterpret_cast<const float4*>(line + (lo ^ 4));
        const float tr[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        float qv[8], c[8];
        row_scales(sq, u, qv);
        dct_row(tr, c);
#pragma unroll
        for (int v = 0; v < 8; ++v) rec[slot + (u * 8 + v) * 8] = quantize_byte<R>(c[v], qv[v]);
      }
    } else {
      // an excluded strip: zeros, by the threads
      uint4* dst = reinterpret_cast<uint4*>(out + a.rec);
      for (int i = threadIdx.x; i < 4 * a.n; i += kM32Threads) dst[i] = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
    __syncthreads();
    if (a.inc) {
      if (storer) store_records(out, a, rec);
      half = (half + 1) % kE32OutBuffers;
    }
    kept += a.inc;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _dec32_kernel.
// Bound: memory, as enc32.  Design: see the head of this file.  A short
// tile's blocks past W compute on stale bytes, and the tensor store drops
// their columns.
__global__ void __launch_bounds__(kM32Threads)
dec32_kernel(const uint8_t* __restrict__ records, const __grid_constant__ Scales qi, M32Geom g,
             const __grid_constant__ CUtensorMap tpix) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kD32Stages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[v*8 + u] = qi[u*8 + v]: column v's scales
  uint8_t* pixs = smem + 64 * 4;               // 128-byte aligned, as the tensor stores want
  uint8_t* stages = pixs + kD32OutBuffers * kM32TileBytes;
  float* cross = reinterpret_cast<float*>(stages + kD32Stages * kM32RecBytes);
  // block b: kM32Lines columns, then rows, from kM32Lines*w
  const int b = threadIdx.x % kM32TileBlocks, w = threadIdx.x / kM32TileBlocks;
  const bool storer = threadIdx.x == kM32Threads - 1;
  // thread 0 brings the CTA's first tiles in before the scales go to
  // shared memory
  M32Ahead ahead(g);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kD32Stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    M32Tile n;
#pragma unroll
    for (int s = 0; s < kD32Stages; ++s)
      if (ahead.next(g, false, n)) load_records(records, n, stages + s * kM32RecBytes, &full[s]);
  }
  for (int i = threadIdx.x; i < 64; i += kM32Threads) sq[(i & 7) * 8 + (i >> 3)] = qi.v[i];
  __syncthreads();
  M32Walk walk = m32_walk(g);
  // this block's byte of coefficient (0, 0) in a staged group
  const int slot = (b >> 3) * kGroupStride + (b & 7);
  unsigned i = 0, half = 0;  // the CTA's tile count; the pixel buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const M32Tile a = m32_tile(g, walk);
    const unsigned s = i % kD32Stages;
    wait_full(&full[s], (i / kD32Stages) & 1);
    const uint8_t* st = stages + s * kM32RecBytes + slot;
#pragma unroll
    for (int h = 0; h < kM32Lines; ++h) {
      // column v of block b: c[u][v] = (b - 127) * qi exactly, then
      // t[j][v] = sum_u D[u][j] c[u][v]
      const int v = kM32Lines * w + h;
      float qv[8], c[8], tt[8];
      row_scales(sq, v, qv);
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = dequant_byte(st[(u * 8 + v) * 8], qv[u]);
      idct_column(c, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) cross[dec_cross(j, v, b, kM32TileBlocks)] = tt[j];
    }
    walk.advance(g.tps, g.s_n);
    // the store of the tile kD32OutBuffers back has read its buffer
    if (storer) bulk_wait_read<kD32OutBuffers - 1>();
    __syncthreads();
    // the records are read: the tile kD32Stages ahead comes into their buffer
    if (threadIdx.x == 0) {
      M32Tile n;
      if (ahead.next(g, false, n)) load_records(records, n, stages + s * kM32RecBytes, &full[s]);
    }
    uint8_t* pix = pixs + half * kM32TileBytes;
#pragma unroll
    for (int h = 0; h < kM32Lines; ++h) {
      // row j of block b: x[j][k] = sum_v t[j][v] D[v][k], clipped, rounded
      // half to even and packed
      const int j = kM32Lines * w + h;
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cross[dec_cross(j, v, b, kM32TileBlocks)];
      *reinterpret_cast<uint2*>(pix + j * kM32RowBytes + 8 * b) = idct_row_pixels<false>(tv);
    }
    fence_async_shared();
    __syncthreads();  // the crossing is read and the pixel tile written
    if (storer) store_pixels(&tpix, a, pix);
    half = (half + 1) % kD32OutBuffers;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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
  tensor_load_3d(m, a.x0, a.y0, a.frame, stage, bar, kRtTileBytes);
}

// The storing thread: tile t's pixel rows by one 3-D tensor store (columns
// past W and rows past H2 are not written).
__device__ __forceinline__ void rt_store(const CUtensorMap* m, const RtGeom& g, unsigned t,
                                         const uint8_t* pix) {
  const RtTile a = rt_at(g, t);
  tensor_store_3d(m, a.x0, a.y0, a.frame, pix);
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

// The round trip's tensor maps: the input (batch frames of h2 rows read
// from frames frame_stride bytes apart) and the output as (W, h2, batch),
// both with the box of a tile: kRtRow columns x 8 * kRtTileStrips rows x 1
// frame.
bool rt_maps(CUtensorMap* tin, CUtensorMap* tout, const void* img, void* out, int batch, int h2,
             int w, long long frame_stride) {
  return view_map(tin, img, batch, h2, w, frame_stride, kRtRow, 8 * kRtTileStrips) &&
         view_map(tout, out, batch, h2, w, (long long)h2 * w, kRtRow, 8 * kRtTileStrips);
}

// The geometry of an encode or decode launch, or false where the plan does
// not fit it: shared bytes as the kernel lays them out, at most one CTA a
// tile, 16-byte pixels, frame stride (at least a view) and records.
bool m32_launch_ok(int batch, int h2, int w, const void* pixels, long long frame_px,
                   const void* records, int grid, int smem, int want_smem, M32Geom* g) {
  if (!mode32_geometry_ok(batch, h2, w) || grid <= 0 || smem != want_smem ||
      frame_px < (long long)h2 * w ||
      (((uintptr_t)pixels | (uintptr_t)frame_px | (uintptr_t)records) & 15))
    return false;
  g->bw = w / 8;
  g->s_n = h2 / 8;
  g->tps = (unsigned)((g->bw + kM32TileBlocks - 1) / kM32TileBlocks);
  const long long tiles = (long long)batch * g->s_n * g->tps;
  if (tiles >= (1ll << 31) || grid > tiles) return false;
  g->tiles = (unsigned)tiles;
  g->frame_rec = (long long)h2 * w;
  return true;
}

// The instantiation of the encode for this rounding, or null.
const void* enc32_fn(int rounding) {
  switch (rounding) {
    case kRne: return (const void*)enc32_kernel<kRne>;
    case kScalar: return (const void*)enc32_kernel<kScalar>;
    case kClampFirst: return (const void*)enc32_kernel<kClampFirst>;
    default: return nullptr;
  }
}

// The tile width and `smem`, and how many CTAs of `fn` an SM holds, and
// the SMs of the current card.
int m32_capacity(const void* fn, int smem, int* nb, int* smem_out, int* per_sm, int* sms) {
  if (!fn) return (int)cudaErrorInvalidValue;
  *nb = kM32TileBlocks;
  *smem_out = smem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kM32Threads, smem);
  return (int)e;
}

}  // namespace

extern "C" {

// The launch of the encode (the rounding's instantiation): its tile width,
// the shared bytes a CTA takes and how many such CTAs an SM holds, and the
// SMs of the current card.
int sdct_enc32_capacity(int rounding, int* nb, int* smem, int* per_sm, int* sms) {
  return m32_capacity(enc32_fn(rounding), kE32Smem, nb, smem, per_sm, sms);
}

// The same for the decode.
int sdct_dec32_capacity(int* nb, int* smem, int* per_sm, int* sms) {
  return m32_capacity((const void*)dec32_kernel, kD32Smem, nb, smem, per_sm, sms);
}

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8 records.  Both 16-byte
// aligned, frame_stride a multiple of 16.  q: 64 host f32.  Strip s is
// encoded iff start_y <= 16*s <= end_y, else zero.  grid and smem: the
// host's launch plan (cuda_dct.enc32_plan); smem must equal what the kernel
// lays out.
int sdct_enc32(const void* img, void* out, const float* q, int batch, int h2, int w,
               long long frame_stride, int start_y, int end_y, int rounding, int grid, int smem,
               void* stream) {
  M32Geom g;
  if (!m32_launch_ok(batch, h2, w, img, frame_stride, out, grid, smem, kE32Smem, &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = enc32_fn(rounding);
  if (!fn) return (int)cudaErrorInvalidValue;
  g.start_y = start_y;
  g.end_y = end_y;
  CUtensorMap tin = {};
  if (!view_map(&tin, img, batch, h2, w, frame_stride, kM32RowBytes, 8))
    return (int)cudaErrorInvalidValue;
  uint8_t* o = (uint8_t*)out;
  Scales s = to_scales(q);
  void* args[] = {(void*)&o, &s, &g, &tin};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kM32Threads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// records: (batch, h2*w) u8.  out: (batch, h2, w) u8.  Both 16-byte
// aligned.  qi: 64 host f32.  grid and smem as for sdct_enc32
// (cuda_dct.dec32_plan).
int sdct_dec32(const void* records, void* out, const float* qi, int batch, int h2, int w,
               int grid, int smem, void* stream) {
  M32Geom g;
  if (!m32_launch_ok(batch, h2, w, out, (long long)h2 * w, records, grid, smem, kD32Smem, &g))
    return (int)cudaErrorInvalidValue;
  g.start_y = 0;
  g.end_y = 0;
  CUtensorMap tpix = {};
  if (!view_map(&tpix, out, batch, h2, w, (long long)h2 * w, kM32RowBytes, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)records;
  Scales s = to_scales(qi);
  void* args[] = {(void*)&in, &s, &g, &tpix};
  return (int)cudaLaunchKernel((const void*)dec32_kernel, dim3(grid), dim3(kM32Threads), args,
                               (size_t)smem, (cudaStream_t)stream);
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

// YCbCr 4:2:0 colour kernels for Hopper (sm_90a): encode and decode of
// planar RGB through a luma record stream and two half-resolution chroma
// record streams.  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by kernels/cuda_dct.py.
//
// Colour 4:2:0: a (3, H, W) u8 planar RGB dual view, of which the top
// H2 = H/2 rows are encoded (W % 128 == 0, H2 % 16 == 0).  Per pixel the
// BT.601 mix in f32 as in color32.cu (mix3, then the bias; no u8 step).  Cb
// and Cr are pooled over each 2x2 pixel square, ((x00 + x01) + (x10 + x11))
// * 0.25 with every step rounded (layout/color420.py pool2x2), to
// (H2/2, W/2) planes.  Each plane then gets the mode32 encode of dct32.cu
// in the raw 0..255 domain, Y with the luma scales and Cb, Cr with the
// chroma scales.  A frame's stream is 1.5*H2*W bytes,
//   [ Y records (H2*W) | Cb records (H2*W/4) | Cr records (H2*W/4) ],
// each segment the mode32 record stream of its plane.  The decode
// dequantizes, runs the IDCT per plane, subtracts the bias, gives each
// chroma value to its 2x2 pixel square and applies the inverse mix in f32
// (the YCbCr values are not rounded), then rounds half to even and clips.
//
// Encode: strip tiles of 8 macroblocks (16 rows x 128 columns x 3 planes;
// W % 128 == 0, so a macroblock row is a whole number of tiles), a
// persistent grid walking tiles numbered over (frame, macroblock row, tile
// of the row), 128 threads a CTA.
//   * Thread 0 brings a tile in by one 4-D tensor copy (box 128 columns x
//     16 rows x 3 planes x 1 frame) completing on an mbarrier, and the
//     CTA's next one as soon as this one's columns are read; the plane
//     stride is the tensor map's, so a shard's rows of a larger image go in
//     as they are.
//   * As columns, thread (Y block b of the tile's 32, column pair cp) reads
//     its two columns of the three planes (each byte once, a 2-byte load a
//     row and plane, to f32 without the conversion unit), mixes Y and runs
//     dct2d's column pass on both columns, and mixes Cb and Cr and pools
//     each 2x2 square in registers (bias before the pool, the pool's
//     order): four pooled values of one column of a chroma block each.
//   * Then, after a barrier, each thread runs two Y row passes (rows cp and
//     cp + 4 of its block) and quantizes them, and one chroma column pass
//     (the 16 chroma blocks, 8 threads each, as the 4:4:4 encode); after a
//     second barrier one chroma row pass.  Values cross through shared
//     buffers free of bank conflicts (ycross for Y, swizzled for the column
//     pairs; pooled_at, the block index XORed on the column's bit 2;
//     cross_at for the chroma).  The basis is compiled into the FMAs
//     (tile_common.cuh).
//   * The records are staged in padded groups (kGroupStride) and leave by
//     six 512-byte bulk stores a tile (the two Y spans of block rows 2my
//     and 2my+1, the Cb and the Cr span); the buffer is reused only after
//     cp.async.bulk.wait_group.read.  One input buffer
//     and one record buffer (k420Stages, k420RecBuffers: 26 KB, 8 CTAs an
//     SM) ran 1-3% faster than two of either (PERF.md).
//   * Every product and sum of the mix, the pool, dct2d and the quantizer
//     is kept in its order: the Y segment equals enc32_rgb's channel 0 and
//     the whole stream the thread-per-block form, byte for byte.
// Decode: the mirror of the encode, on the same tiles and the same walk.
//   * Thread 0 brings a tile's records in by six 512-byte bulk copies (the
//     two Y spans of block rows 2my and 2my+1, two groups each, the Cb and
//     the Cr span) into padded groups (kGroupStride), completing on one
//     mbarrier, k420DecStages tiles ahead.
//   * Three phases, 128 threads (k420DecWarps).  First every thread runs
//     idct2d's first pass over coefficient columns: Y columns cp and cp + 4
//     of Y block (br, bc) and chroma column x of chroma block cb (the
//     encode's threads), each column read straight from the staged records
//     and dequantized exactly ((2^23 + b) - (2^23 + 127), times the scale).
//     After a barrier, the row passes: two Y rows (cp, cp + 4), kept in
//     registers with the bias off, and one chroma row, whose values, bias
//     off, go to the chroma buffer (chroma_at).  After a second barrier
//     each Y row thread reads its square's four Cb and four Cr values (one
//     16-byte load each), gives each to its 2x2 pixels, runs the inverse
//     mix, rounds half to even, clips and packs into the pixel stage,
//     which leaves by one 4-D tensor store a tile (box 128 columns x 16
//     rows x 3 planes x 1 frame; k420DecOutBuffers buffers, each reused
//     only after cp.async.bulk.wait_group.read).  The crossings are
//     cross_at's, the block row as the channel for Y; every shared access
//     is free of bank conflicts.
//   * Every product and sum of idct2d and of the mix is kept in its order
//     and every conversion is exact: the bytes equal the thread-per-block
//     form.

#include "tile_common.cuh"

namespace {

// -- encode: strip tiles of 8 macroblocks -------------------------------------

constexpr int k420TileRow = 128;                     // columns a tile
constexpr int k420TileIn = 3 * 16 * k420TileRow;     // 3 planes x 16 rows
constexpr int k420EncThreads = 128;                  // Y: 4 a block; chroma: 8 a block
constexpr int k420Stages = 1;                        // input tiles in flight
constexpr int k420RecBuffers = 1;                    // record staging buffers
constexpr int k420TileRec = 6 * kGroupStride;        // Y 2 rows x 2 groups, Cb, Cr
constexpr int kYCross = 2 * 64 * 16;                 // f32: 32 Y blocks
constexpr int kChromaCross = 64 * 16;                // f32: 16 chroma blocks
// Shared bytes of a launch: luma and chroma scales, the input tiles, the
// record buffers, the Y crossing, the pooled chroma and the chroma
// crossing.  The host's plan (cuda_dct.color420_smem) computes the same
// and the entry point compares.
constexpr int k420Smem = 2 * 64 * 4 + k420Stages * k420TileIn + k420RecBuffers * k420TileRec +
                         4 * (kYCross + 2 * kChromaCross);

struct Geom420 {
  int bw, mbw;        // 8x8 blocks, macroblocks a row
  unsigned tpr;       // tiles a macroblock row: W / 128
  unsigned rows;      // macroblock rows a frame: H2 / 16
  unsigned tiles;     // of the launch (the host keeps it below 2^31)
  long long y_plane;  // H2*W: the Y segment of a frame's stream
};

struct Tile420 {
  long long frame;
  int my, x;  // macroblock row; tile of the row (macroblocks 8x .. 8x+7)
};

__device__ __forceinline__ Tile420 tile420_at(const Geom420& g, unsigned t) {
  const unsigned fr = t / g.tpr, frame = fr / g.rows;
  Tile420 a;
  a.frame = frame;
  a.my = (int)(fr - frame * g.rows);
  a.x = (int)(t - fr * g.tpr);
  return a;
}

// Thread 0: tile t (if the launch has it) into `stage` by one tensor copy.
__device__ __forceinline__ void load_tile420(const CUtensorMap* tin, const Geom420& g,
                                             unsigned t, uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const Tile420 a = tile420_at(g, t);
  arrive_expect(bar, k420TileIn);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(tin), "r"(k420TileRow * a.x), "r"(16 * a.my), "r"(0), "r"((int)a.frame),
      "r"(saddr(bar))
      : "memory");
}

// The Y crossing: t[r][c] of Y block (br, bc), r the row index.  The column
// pass writes columns c in {4i + e, 4i + 2 + e} (a warp's two column
// pairs) at one r; the row pass reads rows r in {2i + h', 2i + 1 + h'} at
// one c.  Lines of 32 floats hold the columns c and c ^ 2 of one r, in
// halves chosen by bit 0 of r ^ (c >> 1): both accesses touch 32 banks.
__device__ __forceinline__ int ycross(int br, int r, int c, int bc) {
  return (((br * 8 + r) * 4 + (((c >> 2) << 1) | (c & 1))) * 2 + ((r ^ (c >> 1)) & 1)) * 16 + bc;
}

// The pooled chroma: value (row j, column k) of chroma block cb' (Cb 0-7,
// Cr 8-15).  The pool writes, at one j, columns 4(bc & 1) + cp of blocks
// bc >> 1; the column pass reads, at one j, columns {2i, 2i+1} of the 16
// blocks.  Bit 3 of the block swaps on k >= 4: both touch 32 banks.
__device__ __forceinline__ int pooled_at(int j, int k, int cb) {
  return (j * 8 + k) * 16 + (cb ^ ((k >> 2) << 3));
}

// Offset in a frame's stream of record group k of tile a: k < 4 the Y
// group k & 1 of block row 2my + (k >> 1), 4 the Cb group, 5 the Cr group.
__device__ __forceinline__ long long group420_at(const Geom420& g, const Tile420& a, int k) {
  if (k < 4) return ((2LL * a.my + (k >> 1)) * g.bw + 16 * a.x + 8 * (k & 1)) * 64;
  return g.y_plane + (k - 4) * (g.y_plane >> 2) + ((long long)a.my * g.mbw + 8 * a.x) * 64;
}

// Lanes 0-5 of warp 1: the tile's six record groups, one bulk store each.
__device__ __forceinline__ void store420(uint8_t* out, const Geom420& g, unsigned t,
                                         const uint8_t* rec, int lane) {
  if (lane < 6) {
    const Tile420 a = tile420_at(g, t);
    uint8_t* frame = out + a.frame * 3 * (g.y_plane >> 1);
    bulk_store(frame + group420_at(g, a, lane), rec + lane * kGroupStride, 512);
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/color420.py _enc420_kernel.
// Bound: memory, 3 bytes read and 1.5 written per pixel position; the
// matrix-form arithmetic its bytes need (the Y segment == enc32_rgb's
// channel 0) sets a floor above it (PERF.md).  Design: see the head of this
// file.
template <int R>
__global__ void __launch_bounds__(k420EncThreads)
enc420_rgb_kernel(uint8_t* __restrict__ out, Scales ql, Scales qc, ColorMix mix, Geom420 g,
                  const __grid_constant__ CUtensorMap tin) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[k420Stages];
  float* sq = reinterpret_cast<float*>(smem);
  uint8_t* stages = smem + 2 * 64 * 4;
  uint8_t* recs = stages + k420Stages * k420TileIn;
  float* yx = reinterpret_cast<float*>(recs + k420RecBuffers * k420TileRec);
  float* pooled = yx + kYCross;
  float* cx = pooled + kChromaCross;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // columns and Y rows: Y block (br, bc), column pair cp
  const int br = warp >> 1, bc = lane & 15, cp = 2 * (warp & 1) + (lane >> 4);
  // chroma: block cb (Cb 0-7, Cr 8-15), column, then row, x
  const int cb = lane & 15, x = 2 * warp + (lane >> 4);
  put_scales(sq, ql);
  put_scales(sq + 64, qc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < k420Stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < k420Stages; ++s)
      load_tile420(&tin, g, blockIdx.x + s * gridDim.x, stages + s * k420TileIn, &full[s]);
  }
  unsigned i = 0, half = 0;  // the CTA's tile count; the record buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % k420Stages;
    wait_full(&full[s], (i / k420Stages) & 1);
    {
      // columns 8bc + 2cp + e of rows 8br .. 8br + 7: Y, and the pooled Cb
      // and Cr of the 2x2 squares (rows 2rp, 2rp + 1)
      const uint8_t* px = stages + s * k420TileIn + 8 * br * k420TileRow + 8 * bc + 2 * cp;
      float y[2][8];
#pragma unroll
      for (int rp = 0; rp < 4; ++rp) {
        float a[2][2][2];  // chroma, row of the pair, column
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 2 * rp + hh;
          uint32_t w3[3];
#pragma unroll
          for (int p = 0; p < 3; ++p)
            w3[p] = *reinterpret_cast<const uint16_t*>(px + (p * 16 + r) * k420TileRow);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float rr = byte_f32(w3[0], e), gg = byte_f32(w3[1], e), bb = byte_f32(w3[2], e);
            y[e][r] = __fadd_rn(mix3(mix.fwd[0], mix.fwd[1], mix.fwd[2], rr, gg, bb), mix.bias[0]);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              a[c][hh][e] = __fadd_rn(
                  mix3(mix.fwd[3 * c + 3], mix.fwd[3 * c + 4], mix.fwd[3 * c + 5], rr, gg, bb),
                  mix.bias[c + 1]);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
          pooled[pooled_at(4 * br + rp, 4 * (bc & 1) + cp, 8 * c + (bc >> 1))] = __fmul_rn(
              __fadd_rn(__fadd_rn(a[c][0][0], a[c][0][1]), __fadd_rn(a[c][1][0], a[c][1][1])),
              0.25f);
      }
      // dct2d's column pass of both Y columns: t[u][k] = sum_j D[u][j] x[j][k]
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float acc = __fmul_rn(basis(u * 8), y[e][0]);
#pragma unroll
          for (int j = 1; j < 8; ++j) acc = __fmaf_rn(basis(u * 8 + j), y[e][j], acc);
          yx[ycross(br, u, 2 * cp + e, bc)] = acc;
        }
    }
    // the stores of the tile k420RecBuffers back have read its buffer
    if (warp == 1) bulk_wait_read<k420RecBuffers - 1>();
    __syncthreads();
    // the input is read: the tile k420Stages ahead comes into its buffer
    if (threadIdx.x == 0)
      load_tile420(&tin, g, t + k420Stages * gridDim.x, stages + s * k420TileIn, &full[s]);
    uint8_t* rec = recs + half * k420TileRec;
    // Y rows u = cp + 4h: c[u][v] = sum_k t[u][k] D[v][k], quantized
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = cp + 4 * h;
      float tr[8], q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = yx[ycross(br, u, k, bc)];
      row_scales(sq, u, q);
      uint8_t* slot = rec + (2 * br + (bc >> 3)) * kGroupStride + u * 64 + (bc & 7);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = __fmul_rn(tr[0], basis(v * 8));
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = __fmaf_rn(tr[k], basis(v * 8 + k), acc);
        slot[v * 8] = quantize_byte<R>(acc, q[v]);
      }
    }
    // chroma column x of block cb: t[u][x] = sum_j D[u][j] x[j][x]
    {
      float xc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) xc[j] = pooled[pooled_at(j, x, cb)];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float acc = __fmul_rn(basis(u * 8), xc[0]);
#pragma unroll
        for (int j = 1; j < 8; ++j) acc = __fmaf_rn(basis(u * 8 + j), xc[j], acc);
        cx[cross_at(0, u, x, cb)] = acc;
      }
    }
    __syncthreads();
    // chroma row u = x of block cb, quantized with the chroma scales
    {
      float tr[8], q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = cx[cross_at(0, x, k, cb)];
      row_scales(sq + 64, x, q);
      uint8_t* slot = rec + (4 + (cb >> 3)) * kGroupStride + x * 64 + (cb & 7);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = __fmul_rn(tr[0], basis(v * 8));
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = __fmaf_rn(tr[k], basis(v * 8 + k), acc);
        slot[v * 8] = quantize_byte<R>(acc, q[v]);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (warp == 1) store420(out, g, t, rec, lane);
    half = (half + 1) % k420RecBuffers;
  }
  if (warp == 1) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// -- decode: the same tiles, the other way -------------------------------------

// Warps a CTA (2, 4 or 8): a Y block has k420DecWarps threads, each
// taking 8 / k420DecWarps columns, then rows; a chroma block 2*k420DecWarps
// (at 8 warps, half the threads sit out the chroma passes).
constexpr int k420DecWarps = 4;
constexpr int k420DecThreads = 32 * k420DecWarps;
constexpr int k420DecY = 8 / k420DecWarps;
constexpr int k420DecC = (8 + 2 * k420DecWarps - 1) / (2 * k420DecWarps);
static_assert(k420DecWarps == 2 || k420DecWarps == 4 || k420DecWarps == 8, "2, 4 or 8 warps");
constexpr int k420DecStages = 2;       // record buffers in flight
constexpr int k420DecOutBuffers = 1;   // pixel tile buffers
constexpr int kChromaValues = 2 * 8 * 64;  // f32: Cb and Cr, 8 rows of 64 a tile
// Shared bytes of a launch: luma and chroma scales, the pixel buffers, the
// record buffers, the Y and chroma crossings and the chroma values.  The
// host's plan (cuda_dct.color420_smem("dec420_rgb")) computes the same and
// the entry point compares.
constexpr int k420DecSmem = 2 * 64 * 4 + k420DecOutBuffers * k420TileIn +
                            k420DecStages * k420TileRec +
                            4 * (kYCross + kChromaCross + kChromaValues);

// Thread 0: tile t's six record groups (if the launch has it) into `stage`
// by bulk copies, kGroupStride apart, completing on `bar`.
__device__ __forceinline__ void load420(const uint8_t* records, const Geom420& g, unsigned t,
                                        uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const Tile420 a = tile420_at(g, t);
  const uint8_t* frame = records + a.frame * 3 * (g.y_plane >> 1);
  arrive_expect(bar, 6 * 512);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    bulk_load(stage + k * kGroupStride, frame + group420_at(g, a, k), 512, bar);
}

// The storing thread: the tile's pixels by one tensor store.
__device__ __forceinline__ void store_pixels420(const CUtensorMap* tout, const Geom420& g,
                                                unsigned t, const uint8_t* pix) {
  const Tile420 a = tile420_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], "
      "[%5];" ::"l"(tout),
      "r"(k420TileRow * a.x), "r"(16 * a.my), "r"(0), "r"((int)a.frame), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The chroma values: (row r, column k) of plane c (0 Cb, 1 Cr) of the
// tile, its 8 chroma blocks side by side in 64 columns, the two 4-float
// halves of blocks 4-7 swapped.  A chroma row thread writes its block's
// halves (a quarter warp: 8 blocks, one row) and a Y row thread reads the
// 4 columns over its 8 pixels (a quarter warp: 32 columns, one row), each
// over 32 distinct banks.
__device__ __forceinline__ int chroma_at(int c, int r, int k) {
  return (c * 8 + r) * 64 + (k ^ (((k >> 5) & 1) << 2));
}

// Replaces simd_dct_tpu/kernels/color420.py _dec420_kernel.
// Bound: memory, 1.5 bytes read and 3 written per pixel position; the
// matrix-form arithmetic its bytes need sets a floor above it (PERF.md).
// Design: see the head of this file.
__global__ void __launch_bounds__(k420DecThreads)
dec420_rgb_kernel(const uint8_t* __restrict__ records, Scales qil, Scales qic, ColorMix mix,
                  Geom420 g, const __grid_constant__ CUtensorMap tout) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[k420DecStages];
  float* sq = reinterpret_cast<float*>(smem);  // transposed: sq[v*8 + u] = qi[u*8 + v]
  uint8_t* pixs = smem + 2 * 64 * 4;            // 128-byte aligned, as the tensor store wants
  uint8_t* stages = pixs + k420DecOutBuffers * k420TileIn;
  float* yx = reinterpret_cast<float*>(stages + k420DecStages * k420TileRec);
  float* cx = yx + kYCross;
  float* cv = cx + kChromaCross;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Y block (br, bc): columns, then rows, cp + k420DecWarps*e
  const int br = warp / (k420DecWarps / 2), bc = lane & 15;
  const int cp = 2 * (warp % (k420DecWarps / 2)) + (lane >> 4);
  // chroma block cb (Cb 0-7, Cr 8-15): columns, then rows, x + 2*k420DecWarps*e
  const int cb = lane & 15, x = 2 * warp + (lane >> 4);
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sq[(i & 7) * 8 + (i >> 3)] = qil.v[i];
      sq[64 + (i & 7) * 8 + (i >> 3)] = qic.v[i];
    }
#pragma unroll
    for (int s = 0; s < k420DecStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < k420DecStages; ++s)
      load420(records, g, blockIdx.x + s * gridDim.x, stages + s * k420TileRec, &full[s]);
  }
  // this thread's bytes in a staged group: (u, v) at + (u*8 + v)*8
  const int yslot = (2 * br + (bc >> 3)) * kGroupStride + (bc & 7);
  const int cslot = (4 + (cb >> 3)) * kGroupStride + (cb & 7);
  const float cbias = (cb >> 3) ? mix.bias[2] : mix.bias[1];
  unsigned i = 0, half = 0;  // the CTA's tile count; the pixel buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % k420DecStages;
    wait_full(&full[s], (i / k420DecStages) & 1);
    const uint8_t* rec = stages + s * k420TileRec;
#pragma unroll
    for (int e = 0; e < k420DecY; ++e) {
      // Y column v of block (br, bc): c[u][v] = (b - 127) * qil exactly,
      // then t[j][v] = sum_u D[u][j] c[u][v]
      const int v = cp + k420DecWarps * e;
      float qv[8], c[8], tt[8];
      row_scales(sq, v, qv);
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = dequant_byte(rec[yslot + (u * 8 + v) * 8], qv[u]);
      idct_column(c, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) yx[cross_at(br, j, v, bc)] = tt[j];
    }
#pragma unroll
    for (int e = 0; e < k420DecC; ++e) {
      // chroma column xc of block cb, with the chroma scales
      const int xc = x + 2 * k420DecWarps * e;
      if (xc >= 8) break;
      float qv[8], c[8], tt[8];
      row_scales(sq + 64, xc, qv);
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = dequant_byte(rec[cslot + (u * 8 + xc) * 8], qv[u]);
      idct_column(c, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) cx[cross_at(0, j, xc, cb)] = tt[j];
    }
    // the store of the tile k420DecOutBuffers back has read its buffer
    if (storer) bulk_wait_read<k420DecOutBuffers - 1>();
    __syncthreads();
    // the records are read: the tile k420DecStages ahead comes into their buffer
    if (threadIdx.x == 0)
      load420(records, g, t + k420DecStages * gridDim.x, stages + s * k420TileRec, &full[s]);
    // Y rows j = cp + k420DecWarps*h: x[j][k] = sum_v t[j][v] D[v][k], bias off
    float y[k420DecY][8];
#pragma unroll
    for (int h = 0; h < k420DecY; ++h) {
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = yx[cross_at(br, cp + k420DecWarps * h, v, bc)];
      idct_row(tv, y[h]);
#pragma unroll
      for (int k = 0; k < 8; ++k) y[h][k] = __fsub_rn(y[h][k], mix.bias[0]);
    }
#pragma unroll
    for (int e = 0; e < k420DecC; ++e) {
      // chroma row xc of block cb, bias off, into the chroma values
      const int xc = x + 2 * k420DecWarps * e;
      if (xc >= 8) break;
      float tv[8], r[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cx[cross_at(0, xc, v, cb)];
      idct_row(tv, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = __fsub_rn(r[k], cbias);
      const int col = 8 * (cb & 7);
      *reinterpret_cast<float4*>(cv + chroma_at(cb >> 3, xc, col)) =
          make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(cv + chroma_at(cb >> 3, xc, col + 4)) =
          make_float4(r[4], r[5], r[6], r[7]);
    }
    __syncthreads();
    uint8_t* pix = pixs + half * k420TileIn;
#pragma unroll
    for (int h = 0; h < k420DecY; ++h) {
      // pixel row 8br + j, columns 8bc .. 8bc + 7: each chroma value to its
      // 2x2 square, the inverse mix, rounded and clipped, one 8-byte row a
      // plane
      const int j = cp + k420DecWarps * h;
      const int at = chroma_at(0, 4 * br + (j >> 1), 4 * bc);
      const float4 b4 = *reinterpret_cast<const float4*>(cv + at);
      const float4 d4 = *reinterpret_cast<const float4*>(cv + at + 8 * 64);
      const float cbv[4] = {b4.x, b4.y, b4.z, b4.w}, crv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t px[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          px[k] = pixel_bits<false>(mix3(mix.inv[3 * p], mix.inv[3 * p + 1], mix.inv[3 * p + 2],
                                         y[h][k], cbv[k >> 1], crv[k >> 1]));
        *reinterpret_cast<uint2*>(pix + (p * 16 + 8 * br + j) * k420TileRow + 8 * bc) = pack8(px);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (storer) store_pixels420(&tout, g, t, pix);
    half = (half + 1) % k420DecOutBuffers;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

inline bool geometry420_ok(int batch, int h2, int w) {
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 16 == 0 && w % 128 == 0;
}

// The geometry of a launch of `tiles` tiles (the host keeps it below 2^31).
Geom420 geom420(int h2, int w, long long tiles) {
  Geom420 g;
  g.bw = w / 8;
  g.mbw = w / 16;
  g.tpr = (unsigned)(w / k420TileRow);
  g.rows = (unsigned)(h2 / 16);
  g.tiles = (unsigned)tiles;
  g.y_plane = (long long)h2 * w;
  return g;
}

// The tiles of a launch, or -1 where the plan does not fit it: 2^31 tiles
// or more, or a grid of more CTAs than tiles.
long long tiles420(int batch, int h2, int w, int grid) {
  const long long tiles = (long long)batch * (h2 / 16) * (w / k420TileRow);
  return tiles >= (1ll << 31) || grid <= 0 || grid > tiles ? -1 : tiles;
}

const void* enc420_kernel_of(int rounding) {
  switch (rounding) {
    case kRne: return (const void*)enc420_rgb_kernel<kRne>;
    case kScalar: return (const void*)enc420_rgb_kernel<kScalar>;
    case kClampFirst: return (const void*)enc420_rgb_kernel<kClampFirst>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The launch of the encode: the shared bytes a CTA takes and how many such
// CTAs an SM holds (the `rounding` instantiation), and the SMs of the
// current card.
int sdct_color420_capacity(int rounding, int* smem, int* per_sm, int* sms) {
  const void* fn = enc420_kernel_of(rounding);
  if (!fn) return (int)cudaErrorInvalidValue;
  *smem = k420Smem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(fn, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, k420EncThreads, *smem);
  return (int)e;
}

// The same for the decode.
int sdct_dec420_capacity(int* smem, int* per_sm, int* sms) {
  const void* fn = (const void*)dec420_rgb_kernel;
  *smem = k420DecSmem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(fn, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, k420DecThreads, *smem);
  return (int)e;
}

// img: (batch, 3, >= h2 rows, w) u8 planar RGB, planes plane_stride bytes
// apart and frames 3*plane_stride (16-byte address and plane stride); only
// the first h2 rows of each plane are read.  out: (batch, 1.5*h2*w) u8
// streams, 16-byte aligned.  ql, qc: 64 host f32 quant scales of the luma
// and chroma LUTs; mix: 21 host f32, the ColorMix.  grid and smem: the
// host's launch plan (cuda_dct.color420_plan); smem must equal what the
// kernel lays out.
int sdct_enc420_rgb(const void* img, void* out, const float* ql, const float* qc,
                    const float* mix, int batch, int h2, int w, long long plane_stride,
                    int rounding, int grid, int smem, void* stream) {
  if (!geometry420_ok(batch, h2, w) || smem != k420Smem ||
      (((uintptr_t)img | (uintptr_t)plane_stride | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  const long long tiles = tiles420(batch, h2, w, grid);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  const void* fn = enc420_kernel_of(rounding);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tin = {};
  if (!planes_map(&tin, img, batch, h2, w, plane_stride, 16)) return (int)cudaErrorInvalidValue;
  Geom420 g = geom420(h2, w, tiles);
  uint8_t* o = (uint8_t*)out;
  Scales sl = to_scales(ql), sc = to_scales(qc);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&o, &sl, &sc, &m, &g, &tin};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(k420EncThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// records: (batch, 1.5*h2*w) u8 streams, 16-byte aligned.  out: (batch, 3,
// h2, w) u8, 16-byte aligned.  qil, qic: 64 host f32 dequant scales each;
// mix as for sdct_enc420_rgb.  grid and smem: the host's launch plan
// (cuda_dct.color420_plan, kind "dec420_rgb"); smem must equal what the
// kernel lays out.
int sdct_dec420_rgb(const void* records, void* out, const float* qil, const float* qic,
                    const float* mix, int batch, int h2, int w, int grid, int smem,
                    void* stream) {
  if (!geometry420_ok(batch, h2, w) || smem != k420DecSmem ||
      (((uintptr_t)records | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  const long long tiles = tiles420(batch, h2, w, grid);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)dec420_rgb_kernel;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tout = {};
  if (!planes_map(&tout, out, batch, h2, w, (long long)h2 * w, 16))
    return (int)cudaErrorInvalidValue;
  Geom420 g = geom420(h2, w, tiles);
  const uint8_t* in = (const uint8_t*)records;
  Scales sil = to_scales(qil), sic = to_scales(qic);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&in, &sil, &sic, &m, &g, &tout};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(k420DecThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

}  // extern "C"

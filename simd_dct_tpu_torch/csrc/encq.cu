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
// Strip s is kept iff start_y <= 16*s <= end_y (8*s with legacy_range);
// every byte of an excluded strip is 0, apart from that spill.
//
// Design: strip tiles, kEqBlockThreads = 2 threads a block, a persistent
// grid (the form of stereo.cu).
//   * A tile is kEqTileBlocks = nb = 32 consecutive blocks of one strip of
//     one frame: 8 pixel rows of 8nb bytes, and -- in every layout -- the
//     64nb consecutive record bytes at 64*(s*BW + bx0) of the frame's
//     records.  Tiles never cross a strip; the last of a strip is short
//     where nb does not divide BW.  CTA i takes tiles i, i + grid, ...,
//     numbered over (frame, strip, tile of the strip), walked without
//     divisions (tile_common.cuh TileWalk, shared with stereo.cu).
//   * Pixels.  kTensor variant (W % 16 == 0, 16-byte pixel address and
//     frame stride): one thread brings a tile in by one 3-D tensor copy of
//     the view read as (W, H2, B) with the frame stride, on an mbarrier,
//     and the CTA's next kept tile as soon as this one's pixels are read;
//     the decode's pixel rows leave by one tensor store a tile, from two
//     alternating buffers.  kPlain variant (any other W % 8 == 0 on 8-byte
//     addresses, e.g. W % 16 == 8): the threads' own 8-byte loads
//     (tile_common.cuh load_rows_plain) and stores.  cuda_dct.encq_plan /
//     decq_plan pick the variant.
//   * Records.  A tile's records are contiguous in every layout: the encode
//     stages them in a buffer of 64nb bytes (two, alternating: 7% faster
//     at 4K than one) and sends them out by one 1-D bulk store; the decode
//     brings them in by one 1-D bulk load on an mbarrier (the next tile's
//     as soon as this one's are read).
//   * Encode: a thread reads kEqLines columns of its block (each byte once,
//     exactly to f32 off the conversion unit), scales them by 1/255 and
//     runs dct2d's column pass; t[u][k] crosses through shared memory
//     (tile_common.cuh enc_cross) to the thread of rows R, which runs the
//     row pass and quantizes (tile_common.cuh dct_column, dct_row,
//     quantize_byte; rne's +127 added to a packed word at once).  R is the
//     rows whose bytes share a record word: scalar {4g..4g+3}, pair
//     {0,1,4,5} or {2,3,6,7}, so the thread packs one word
//     a coefficient column v and the pair permutation is only the staging
//     index.  The 8 words of a block's rows sit 8 bytes apart and a warp's
//     blocks 64 apart, which would put a warp's stores on two banks: each
//     lane stores its words starting at column (b >> 1) & 7 (a rotation of
//     its registers by selects), which spreads them over 16.
//   * Decode, the mirror: a thread reads column v of its block's record
//     (scalar: 8 consecutive bytes; pair: a word of each half), dequantizes
//     ((b - 127) exactly, times the scale) and runs idct2d's first pass; the
//     thread of rows j the second, times 255, rounds half to even, clips and
//     packs 8 pixels (tile_common.cuh dequant_byte, dec_cross and
//     idct_row_pixels).  The
//     columns a thread takes are visited from (b >> 1) & 3 on, for the same
//     reason as the encode's words.  The DCT basis is compiled into the
//     FMAs as immediates (tile_common.cuh basis).
//   * pair_as_written: the tile that computes a strip's last cell also
//     stores its second half, when the next strip is excluded, to that
//     strip's first 64 bytes (a second bulk store), and its own zero half
//     by the threads' stores; the excluded strip's first tile stores its
//     zeros from byte 64 on.  Every output byte has one writer.
//   * Excluded strips load nothing and store zeros.
//   * Every product and sum of dct2d / idct2d and of the quantizer is kept
//     in its order and every conversion is exact, so the bytes equal the
//     thread-per-block form that dct_common.cuh's functions give.
// Bound: memory, 1 byte read and 1 written per pixel; the matrix form the
// bytes fix sets an arithmetic floor above it (PERF.md): the kernels are
// bound by their instructions (encq_variants.py).

#include "tile_common.cuh"

namespace {

constexpr int kEqTileBlocks = 32;                 // nb: blocks of one strip a tile
constexpr int kEqBlockThreads = 2;                // threads an 8x8 block
constexpr int kEqLines = 8 / kEqBlockThreads;     // columns, then rows, a thread
constexpr int kEqThreads = kEqBlockThreads * kEqTileBlocks;
constexpr int kEqRowBytes = 8 * kEqTileBlocks;    // a pixel row of a tile
constexpr int kEqTileBytes = 64 * kEqTileBlocks;  // its 8 pixel rows, or its records
constexpr int kEqCrossBytes = 4 * 64 * kEqTileBlocks;
constexpr int kEqStages = 1;                      // the encode's pixel tiles in flight
constexpr int kEqOutBuffers = 2;                  // its record buffers
constexpr int kDqStages = 1;                      // the decode's record tiles in flight
constexpr int kDqOutBuffers = 2;                  // its pixel buffers
static_assert(kEqTileBlocks % 8 == 0 && kEqTileBlocks <= 32,
              "whole pair cells; a tensor box holds at most 256 columns");
static_assert(kEqLines == 2 || kEqLines == 4, "2 or 4 threads a block");
// Shared bytes of a launch: the scales, the pixel tiles, the record
// buffers, the f32 crossing buffer.  The host's plan (cuda_dct.encq_smem,
// decq_smem) computes the same and the entry points compare.
constexpr int kEqSmem = 64 * 4 + (kEqStages + kEqOutBuffers) * kEqTileBytes + kEqCrossBytes;
constexpr int kDqSmem = 64 * 4 + (kDqStages + kDqOutBuffers) * kEqTileBytes + kEqCrossBytes;
static_assert(kEqSmem <= 48 * 1024 && kDqSmem <= 48 * 1024, "no opt-in attribute needed");

enum Layout { kScalarLayout = 0, kPair = 1, kPairAsWritten = 2 };

struct EqGeom {
  int w, bw;              // W, blocks a strip row
  int s_n;                // strips a frame: H2 / 8
  unsigned tps;           // tiles a strip
  unsigned tiles;         // of the launch (the host keeps it below 2^31)
  long long frame_px;     // bytes from a frame's pixels to the next frame's
  long long frame_rec;    // record bytes a frame: H2 * W
  int start_y, end_y, legacy;
};

struct EqTile {
  long long rec;  // its first record byte, from the launch's records
  int frame, s;
  int bx0, n;     // first block of the strip, blocks
  bool inc;       // its strip is kept
  bool spill;     // as-written: its last cell's second half goes to the next strip
  bool skip;      // as-written: its first 64 bytes are the previous strip's spill
};

__device__ __forceinline__ bool strip_kept(const EqGeom& g, int s) {
  const long long y = g.legacy ? 8LL * s : 16LL * s;  // legacy: the NoSimd y test
  return y >= g.start_y && y <= g.end_y;
}

// The tiles are numbered over (frame, strip, tile of the strip): a
// TileWalk (tile_common.cuh, shared with stereo.cu) whose rows are a
// frame's strips.
typedef TileWalk<kEqTileBlocks> EqWalk;

__device__ __forceinline__ EqWalk walk_of(const EqGeom& g) {
  return EqWalk(blockIdx.x, gridDim.x, g.tps, g.s_n);
}

__device__ __forceinline__ void advance(EqWalk& w, const EqGeom& g) { w.advance(g.tps, g.s_n); }

// The tile the walk is at, with its strip's fate in layout L.
template <int L>
__device__ __forceinline__ EqTile tile_of(const EqGeom& g, const EqWalk& w) {
  EqTile a;
  a.frame = (int)w.f;
  a.s = (int)w.r;
  a.bx0 = w.bx0();
  a.n = w.blocks(g.bw);
  a.rec = (long long)w.f * g.frame_rec + 64LL * ((long long)a.s * g.bw + a.bx0);
  a.inc = strip_kept(g, a.s);
  const bool aw = L == kPairAsWritten;
  a.spill = aw && a.inc && w.x == g.tps - 1 && a.s + 1 < g.s_n && !strip_kept(g, a.s + 1);
  a.skip = aw && !a.inc && w.x == 0 && a.s > 0 && strip_kept(g, a.s - 1);
  return a;
}

// Thread 0's walk ahead of its CTA's tiles, for the loads: tiles t, t +
// grid, ... in the CTA's order.
struct EqAhead {
  EqWalk walk;
  unsigned t;

  __device__ __forceinline__ EqAhead(const EqGeom& g) : walk(walk_of(g)), t(blockIdx.x) {}

  // The next tile whose strip is kept (false: none is left), and past it.
  template <int L>
  __device__ __forceinline__ bool next_kept(const EqGeom& g, EqTile& a) {
    while (t < g.tiles) {
      a = tile_of<L>(g, walk);
      advance(walk, g);
      t += gridDim.x;
      if (a.inc) return true;
    }
    return false;
  }
};

// One thread: tile a's pixel rows into `stage` by one 3-D tensor copy,
// completing on `bar` with the whole box (a short tile's columns past W
// come in as zeros).
__device__ __forceinline__ void load_pixels(const CUtensorMap* m, const EqTile& a, uint8_t* stage,
                                            uint64_t* bar) {
  tensor_load_3d(m, 8 * a.bx0, 8 * a.s, a.frame, stage, bar, kEqTileBytes);
}

// The storing thread: tile a's pixel rows by one 3-D tensor store (columns
// past W are not written).
__device__ __forceinline__ void store_pixels(const CUtensorMap* m, const EqTile& a,
                                             const uint8_t* pix) {
  tensor_store_3d(m, 8 * a.bx0, 8 * a.s, a.frame, pix);
}

__device__ __forceinline__ long long pixel_row(const EqGeom& g, const EqTile& a, int r) {
  return (long long)a.frame * g.frame_px + (8LL * a.s + r) * g.w + 8 * a.bx0;
}

// The storing thread: tile a's records out of `rec` by 1-D bulk stores --
// all 64n bytes, but as-written: the first 64 left to the previous
// strip's spill (skip), or the last 64 sent to the next strip (spill; the
// zero half they replace is stored by the threads).
__device__ __forceinline__ void store_records(uint8_t* out, const EqTile& a, const uint8_t* rec) {
  uint8_t* dst = out + a.rec;
  const unsigned end = 64u * a.n, lo = a.skip ? 64u : 0u, hi = a.spill ? end - 64u : end;
  bulk_store(dst + lo, rec + lo, hi - lo);
  if (a.spill) bulk_store(dst + end, rec + end - 64, 64);
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Row group grp's half of a pair cell (kEqLines rows a group).
__device__ __forceinline__ int half_of(int grp) { return kEqLines == 4 ? grp : grp >> 1; }

// Row i of row group grp: the rows whose bytes share a staged word
// (kEqLines = 4) or half-word (2), byte i holding row i.  scalar: u =
// kEqLines*grp + i; pair: the u-quad of the group's half, in cell order.
template <int L>
__device__ __forceinline__ int row_of(int grp, int i) {
  if (L == kScalarLayout) return kEqLines * grp + i;
  const int quad = kEqLines == 4 ? i : 2 * (grp & 1) + i;  // index in the u-quad
  return 2 * half_of(grp) + 4 * (quad >> 1) + (quad & 1);
}

// Where row group grp of block b stages column v = 0 (column v: + 8v), in
// the tile's records: the layout's permutation as an index.
template <int L>
__device__ __forceinline__ int staged_at(int b, int grp) {
  if (L == kScalarLayout) return 64 * b + kEqLines * grp;
  return 128 * (b >> 1) + 64 * half_of(grp) + 4 * (b & 1) + (kEqLines == 4 ? 0 : 2 * (grp & 1));
}

// quantize_byte<R>'s byte in the low 8 bits of a word, but rne's without
// its +127: the packed word takes that in one carry-free byte add
// (bias_bytes; measured 4% faster than a byte at a time), which no other
// kernel does, so this quantizer stays here.
template <int R>
__device__ __forceinline__ uint32_t quant_bits(float c, float q) {
  if (R != kRne) return quantize_byte<R>(c, q);
  return rint_bits(fminf(fmaxf(__fmul_rn(c, q), -127.0f), 128.0f));
}

// 127 added to each byte of w, modulo 256.
__device__ __forceinline__ uint32_t bias_bytes(uint32_t w) {
  return ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) ^ (w & 0x80808080u);
}

// Byte b (its low byte) into byte i of w.
__device__ __forceinline__ uint32_t put_byte(uint32_t w, uint32_t b, int i) {
  return __byte_perm(w, b, i == 1 ? 0x3240 : (i == 2 ? 0x3410 : 0x4210));
}

// A row group's 8 staged words (half-words for kEqLines = 2), wd[v] the
// bytes of column v, to p + 8v.  Stored from column rot on: wd is rotated
// by rot first (three stages of selects, no runtime register index).
__device__ __forceinline__ void stage_words(uint8_t* p, uint32_t (&wd)[8], int rot) {
#pragma unroll
  for (int sft = 1; sft < 8; sft <<= 1) {
    uint32_t nw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) nw[k] = (rot & sft) ? wd[(k + sft) & 7] : wd[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) wd[k] = nw[k];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // wd[k] holds column (k + rot) & 7
    uint8_t* dst = p + 8 * ((k + rot) & 7);
    if (kEqLines == 4) *reinterpret_cast<uint32_t*>(dst) = wd[k];
    else *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[k];
  }
}

// (b - 127) * q for byte i of w (tile_common.cuh dequant_byte).
__device__ __forceinline__ float dequant_at(uint32_t w, int i, float q) {
  return dequant_byte(__byte_perm(w, 0, 0x4440 + i), q);
}

// Thread 0 (after the mbarriers' init): the next kept tile's pixels into
// `stage`, if one is left.
template <int L>
__device__ __forceinline__ void load_next(EqAhead& ahead, const EqGeom& g, const CUtensorMap* m,
                                          uint8_t* stage, uint64_t* bar) {
  EqTile n;
  if (ahead.next_kept<L>(g, n)) load_pixels(m, n, stage, bar);
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _encq_pair_kernel (all three
// layouts; its scalar_pi permutation matmul is the scalar staging index
// here).  Design: see the head of this file.
template <int R, int L, int V>
__global__ void __launch_bounds__(kEqThreads)
encq_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
            const __grid_constant__ Scales q, EqGeom g,
            const __grid_constant__ CUtensorMap tin) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kEqStages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[u*8 + v] = q[v*8 + u]: row u's scales
  uint8_t* stages = smem + 64 * 4;             // 128-byte aligned, as the tensor copies want
  uint8_t* recs = stages + kEqStages * kEqTileBytes;
  float* cross = reinterpret_cast<float*>(recs + kEqOutBuffers * kEqTileBytes);
  // kEqLines columns from kEqLines*cq of block cb; then row group grp of block b
  const int cb = threadIdx.x / kEqBlockThreads, cq = threadIdx.x % kEqBlockThreads;
  const int b = threadIdx.x % kEqTileBlocks, grp = threadIdx.x / kEqTileBlocks;
  const bool storer = threadIdx.x == kEqThreads - 1;
  // thread 0 brings the CTA's first kept tiles in (kTensor) before the
  // scales go to shared memory
  EqAhead ahead(g);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kEqStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (V == kTensor) {
#pragma unroll
      for (int s = 0; s < kEqStages; ++s)
        load_next<L>(ahead, g, &tin, stages + s * kEqTileBytes, &full[s]);
    }
  }
  for (int i = threadIdx.x; i < 64; i += kEqThreads) sq[(i & 7) * 8 + (i >> 3)] = q.v[i];
  __syncthreads();
  EqWalk walk = walk_of(g);
  EqTile a = tile_of<L>(g, walk);
  const int rot = (b >> 1) & 7;
  unsigned kept = 0, half = 0;  // the CTA's kept tiles so far; the record buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const unsigned s = kept % kEqStages;
    uint8_t* stage = stages + (V == kTensor ? s : 0) * kEqTileBytes;
    if (a.inc) {
      if (V == kTensor) wait_full(&full[s], (kept / kEqStages) & 1);
      else load_rows_plain<kEqTileBlocks, kEqThreads>(img + pixel_row(g, a, 0), g.w, a.n, stage);
      // columns k = kEqLines*cq + h of block cb: t[u][k] = sum_j D[u][j] x[j][k]
      float x[kEqLines][8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint8_t* p = stage + r * kEqRowBytes + cb * 8 + kEqLines * cq;
        const uint32_t bytes = kEqLines == 4 ? *reinterpret_cast<const uint32_t*>(p)
                                             : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
        for (int h = 0; h < kEqLines; ++h) x[h][r] = __fmul_rn(byte_f32(bytes, h), kInv255);
      }
      float tc[kEqLines][8];
#pragma unroll
      for (int h = 0; h < kEqLines; ++h) dct_column(x[h], tc[h]);
#pragma unroll
      for (int uu = 0; uu < 8; ++uu) {
        float* dst = cross + enc_cross(uu, kEqLines * cq, cb, kEqTileBlocks);
        if (kEqLines == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(tc[0][uu], tc[1][uu],
                                                        tc[2 % kEqLines][uu], tc[3 % kEqLines][uu]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(tc[0][uu], tc[1][uu]);
      }
    }
    advance(walk, g);
    const EqTile next = tile_of<L>(g, walk);
    // the store of the tile kEqOutBuffers back has read its buffer
    if (storer) bulk_wait_read<kEqOutBuffers - 1>();
    __syncthreads();
    // the pixels are read: the CTA's kept tile kEqStages ahead comes in
    // under the rows
    if (V == kTensor && threadIdx.x == 0 && a.inc) load_next<L>(ahead, g, &tin, stage, &full[s]);
    kept += a.inc;
    uint8_t* rec = recs + half * kEqTileBytes;
    if (a.inc) {
      // rows u of group grp of block b: c[u][v] = sum_k t[u][k] D[v][k],
      // quantized into byte i of the group's word for column v
      const int lo = ((b >> 2) & 1) << 2;
      uint32_t wd[8];
#pragma unroll
      for (int i = 0; i < kEqLines; ++i) {
        const int u = row_of<L>(grp, i);
        const float* line = cross + u * 8 * kEqTileBlocks + b * 8;
        const float4 t0 = *reinterpret_cast<const float4*>(line + lo);
        const float4 t1 = *reinterpret_cast<const float4*>(line + (lo ^ 4));
        const float tr[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        float qv[8], c[8];
        row_scales(sq, u, qv);
        dct_row(tr, c);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const uint32_t byte = quant_bits<R>(c[v], qv[v]);
          wd[v] = i == 0 ? byte : put_byte(wd[v], byte, i);
        }
      }
      if (R == kRne) {
#pragma unroll
        for (int v = 0; v < 8; ++v) wd[v] = bias_bytes(wd[v]);
      }
      // as-written: second halves are zero, but for the spill of a strip's
      // last cell
      if (L == kPairAsWritten && half_of(grp) == 1 && !(a.spill && b >= a.n - 2)) {
#pragma unroll
        for (int v = 0; v < 8; ++v) wd[v] = 0;
      }
      stage_words(rec + staged_at<L>(b, grp), wd, rot);
      // the zero half a spill's store leaves out
      if (L == kPairAsWritten && a.spill && threadIdx.x < 4)
        reinterpret_cast<uint4*>(out + a.rec + 64 * a.n - 64)[threadIdx.x] = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < kEqTileBytes / 16 / kEqThreads; ++i)
        reinterpret_cast<uint4*>(rec)[i * kEqThreads + threadIdx.x] = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
    __syncthreads();
    if (storer) store_records(out, a, rec);
    half = (half + 1) % kEqOutBuffers;
    a = next;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _decq_pair_kernel (scalar and
// pair records).  Design: see the head of this file.
template <int L, int V>
__global__ void __launch_bounds__(kEqThreads)
decq_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out,
            const __grid_constant__ Scales qi, EqGeom g,
            const __grid_constant__ CUtensorMap tpix) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kDqStages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[v*8 + u] = qi[v*8 + u]: column v's scales
  uint8_t* stages = smem + 64 * 4;             // 128-byte aligned, as the bulk copies want
  uint8_t* pixs = stages + kDqStages * kEqTileBytes;
  float* cross = reinterpret_cast<float*>(pixs + kDqOutBuffers * kEqTileBytes);
  // block b: kEqLines columns, then rows, from kEqLines*w
  const int b = threadIdx.x % kEqTileBlocks, w = threadIdx.x / kEqTileBlocks;
  const int rot = (b >> 1) & (kEqLines - 1);
  const bool storer = threadIdx.x == kEqThreads - 1;
  // thread 0 brings the CTA's first tiles in before the scales go to
  // shared memory
  EqWalk walk = walk_of(g);
  EqWalk ahead = walk;  // thread 0: the next tile to load
  unsigned t_ahead = blockIdx.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDqStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      if (t_ahead < g.tiles) {
        const EqTile n = tile_of<L>(g, ahead);
        arrive_expect(&full[s], 64u * n.n);
        bulk_load(stages + s * kEqTileBytes, records + n.rec, 64u * n.n, &full[s]);
      }
      advance(ahead, g);
      t_ahead += gridDim.x;
    }
  }
  for (int i = threadIdx.x; i < 64; i += kEqThreads) sq[i] = qi.v[i];
  __syncthreads();
  unsigned i = 0, half = 0;  // the CTA's tile count; the pixel buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const EqTile a = tile_of<L>(g, walk);
    const unsigned s = i % kDqStages;
    wait_full(&full[s], (i / kDqStages) & 1);
    const uint8_t* st = stages + s * kEqTileBytes;
#pragma unroll
    for (int h = 0; h < kEqLines; ++h) {
      // column v of block b: c[u][v] = (b - 127) * qi exactly, then
      // t[j][v] = sum_u D[u][j] c[u][v]
      const int v = kEqLines * w + ((h + rot) & (kEqLines - 1));
      float qv[8], c[8], tt[8];
      row_scales(sq, v, qv);
      if (L == kScalarLayout) {
        const uint2 col = *reinterpret_cast<const uint2*>(st + 64 * b + 8 * v);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c[u] = dequant_at(col.x, u, qv[u]);
          c[u + 4] = dequant_at(col.y, u, qv[u + 4]);
        }
      } else {
        const uint8_t* cell = st + 128 * (b >> 1) + 8 * v + 4 * (b & 1);
        const uint32_t h0 = *reinterpret_cast<const uint32_t*>(cell);
        const uint32_t h1 = *reinterpret_cast<const uint32_t*>(cell + 64);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {  // u-quads {0,1,4,5} and {2,3,6,7}
          const int u = 4 * (q4 >> 1) + (q4 & 1);
          c[u] = dequant_at(h0, q4, qv[u]);
          c[u + 2] = dequant_at(h1, q4, qv[u + 2]);
        }
      }
      idct_column(c, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) cross[dec_cross(j, v, b, kEqTileBlocks)] = tt[j];
    }
    advance(walk, g);
    // the store of the tile kDqOutBuffers back has read its buffer
    if (V == kTensor && storer) bulk_wait_read<kDqOutBuffers - 1>();
    __syncthreads();
    // the records are read: the tile kDqStages ahead comes into their buffer
    if (threadIdx.x == 0) {
      if (t_ahead < g.tiles) {
        const EqTile n = tile_of<L>(g, ahead);
        arrive_expect(&full[s], 64u * n.n);
        bulk_load(stages + s * kEqTileBytes, records + n.rec, 64u * n.n, &full[s]);
      }
      advance(ahead, g);
      t_ahead += gridDim.x;
    }
    uint8_t* pix = pixs + half * kEqTileBytes;
#pragma unroll
    for (int h = 0; h < kEqLines; ++h) {
      // row j of block b: x[j][k] = sum_v t[j][v] D[v][k], times 255,
      // clipped, rounded half to even and packed
      const int j = kEqLines * w + h;
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cross[dec_cross(j, v, b, kEqTileBlocks)];
      const uint2 row = idct_row_pixels<true>(tv);
      if (V == kTensor)
        *reinterpret_cast<uint2*>(pix + j * kEqRowBytes + 8 * b) = row;
      else if (b < a.n)
        *(reinterpret_cast<uint2*>(out + pixel_row(g, a, j)) + b) = row;
    }
    if (V == kTensor) fence_async_shared();
    __syncthreads();  // the crossing is read (and the pixel tile written)
    if (V == kTensor && storer) store_pixels(&tpix, a, pix);
    half = (half + 1) % kDqOutBuffers;
  }
  if (V == kTensor && storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool geometry_ok(int batch, int h2, int w, int layout) {
  const int wmul = layout == kScalarLayout ? 8 : 16;
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 8 == 0 && w % wmul == 0 &&
         layout >= kScalarLayout && layout <= kPairAsWritten;
}

// The geometry of a launch, or false where the plan does not fit it:
// shared bytes as the kernel lays them out, at most one CTA a tile,
// 16-byte records, 8-byte pixel rows and frame stride (at least a view),
// and kTensor only for W % 16 == 0 on 16-byte pixel addresses and stride.
bool launch_ok(int batch, int h2, int w, int layout, const void* pixels, long long frame_px,
               const void* records, int grid, int variant, int smem, int want_smem, EqGeom* g) {
  if (!geometry_ok(batch, h2, w, layout) || grid <= 0 || smem != want_smem ||
      (variant != kPlain && variant != kTensor) || frame_px < (long long)h2 * w)
    return false;
  const uintptr_t pix = (uintptr_t)pixels | (uintptr_t)frame_px;
  if ((pix & 7) || ((uintptr_t)records & 15)) return false;
  if (variant == kTensor && ((pix & 15) || w % 16)) return false;
  g->w = w;
  g->bw = w / 8;
  g->s_n = h2 / 8;
  g->tps = (unsigned)((g->bw + kEqTileBlocks - 1) / kEqTileBlocks);
  const long long tiles = (long long)batch * g->s_n * g->tps;
  if (tiles >= (1ll << 31) || grid > tiles) return false;
  g->tiles = (unsigned)tiles;
  g->frame_px = frame_px;
  g->frame_rec = (long long)h2 * w;
  return true;
}

template <int R, int L>
const void* encq_fn_of(int variant) {
  return variant == kTensor ? (const void*)encq_kernel<R, L, kTensor>
                            : (const void*)encq_kernel<R, L, kPlain>;
}

template <int R>
const void* encq_fn_r(int layout, int variant) {
  switch (layout) {
    case kScalarLayout: return encq_fn_of<R, kScalarLayout>(variant);
    case kPair: return encq_fn_of<R, kPair>(variant);
    case kPairAsWritten: return encq_fn_of<R, kPairAsWritten>(variant);
    default: return nullptr;
  }
}

// The instantiation of the encode for these options, or null.
const void* encq_fn(int rounding, int layout, int variant) {
  if (variant != kPlain && variant != kTensor) return nullptr;
  switch (rounding) {
    case kRne: return encq_fn_r<kRne>(layout, variant);
    case kScalar: return encq_fn_r<kScalar>(layout, variant);
    case kClampFirst: return encq_fn_r<kClampFirst>(layout, variant);
    default: return nullptr;
  }
}

// The instantiation of the decode for these options, or null.
const void* decq_fn(int layout, int variant) {
  if (variant != kPlain && variant != kTensor) return nullptr;
  if (layout == kScalarLayout)
    return variant == kTensor ? (const void*)decq_kernel<kScalarLayout, kTensor>
                              : (const void*)decq_kernel<kScalarLayout, kPlain>;
  if (layout == kPair)
    return variant == kTensor ? (const void*)decq_kernel<kPair, kTensor>
                              : (const void*)decq_kernel<kPair, kPlain>;
  return nullptr;
}

// The tile width and `smem`, and how many CTAs of `fn` an SM holds, and
// the SMs of the current card.
int capacity_of(const void* fn, int smem, int* nb, int* smem_out, int* per_sm, int* sms) {
  if (!fn) return (int)cudaErrorInvalidValue;
  *nb = kEqTileBlocks;
  *smem_out = smem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kEqThreads, smem);
  return (int)e;
}

}  // namespace

extern "C" {

// The launch of the encode (the rounding, layout and variant
// instantiation): its tile width, the shared bytes a CTA takes and how many
// such CTAs an SM holds, and the SMs of the current card.
int sdct_encq_capacity(int rounding, int layout, int variant, int* nb, int* smem, int* per_sm,
                       int* sms) {
  return capacity_of(encq_fn(rounding, layout, variant), kEqSmem, nb, smem, per_sm, sms);
}

// The same for the decode (layout 0 scalar or 1 pair).
int sdct_decq_capacity(int layout, int variant, int* nb, int* smem, int* per_sm, int* sms) {
  return capacity_of(decq_fn(layout, variant), kDqSmem, nb, smem, per_sm, sms);
}

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8, 16-byte aligned.  q: 64
// host f32 in buffer order.  layout: 0 scalar, 1 pair, 2 pair_as_written.
// grid, variant (0 plain, 1 tensor) and smem: the host's launch plan
// (cuda_dct.encq_plan); smem must equal what the kernel lays out.
int sdct_encq(const void* img, void* out, const float* q, int batch, int h2, int w,
              long long frame_stride, int start_y, int end_y, int legacy_range, int rounding,
              int layout, int grid, int variant, int smem, void* stream) {
  EqGeom g;
  if (!launch_ok(batch, h2, w, layout, img, frame_stride, out, grid, variant, smem, kEqSmem, &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = encq_fn(rounding, layout, variant);
  if (!fn) return (int)cudaErrorInvalidValue;
  g.start_y = start_y;
  g.end_y = end_y;
  g.legacy = legacy_range ? 1 : 0;
  CUtensorMap tin = {};
  if (variant == kTensor && !view_map(&tin, img, batch, h2, w, frame_stride, kEqRowBytes, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  Scales s = to_scales(q);
  void* args[] = {(void*)&in, (void*)&o, &s, &g, &tin};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kEqThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// records: (batch, h2*w) u8, 16-byte aligned, layout 0 scalar or 1 pair.
// out: (batch, h2, w) u8.  qi: 64 host f32 in buffer order.  grid,
// variant and smem as for sdct_encq (cuda_dct.decq_plan).
int sdct_decq(const void* records, void* out, const float* qi, int batch, int h2, int w,
              int layout, int grid, int variant, int smem, void* stream) {
  EqGeom g;
  if (!launch_ok(batch, h2, w, layout, out, (long long)h2 * w, records, grid, variant, smem,
                 kDqSmem, &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = decq_fn(layout, variant);
  if (!fn) return (int)cudaErrorInvalidValue;
  g.start_y = 0;
  g.end_y = 0;
  g.legacy = 0;
  CUtensorMap tpix = {};
  if (variant == kTensor &&
      !view_map(&tpix, out, batch, h2, w, (long long)h2 * w, kEqRowBytes, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)records;
  uint8_t* o = (uint8_t*)out;
  Scales s = to_scales(qi);
  void* args[] = {(void*)&in, (void*)&o, &s, &g, &tpix};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kEqThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

}  // extern "C"

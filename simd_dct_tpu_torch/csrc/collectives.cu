// The plane all-gather of the dist path and its one-card preflight, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by
// simd_dct_tpu_torch/dist/collectives.py.
//
// ring_gather_kernel replaces simd_dct_tpu/dist/collectives.py:215 (the
// kernel of gather_planes_remote): each of the n ranks of a ring holds an
// (outer, chunk, inner) u8 segment; every rank ends with the (outer,
// n*chunk, inner) planes, rank k's segment in slot k.  The TPU kernel
// forwards the newest slot n-1 times around the ICI ring by remote DMA.
// The cards of an H100 host are linked all to all (NVSwitch), so this one
// pushes to all: the CTAs of a rank read its segment once and store it into
// slot my_id of its own output and of every peer's, through the peer's
// pointer.  The bytes are the contract, not the route.
//
// selfring_kernel replaces simd_dct_tpu/dist/collectives.py:310 (the kernel
// of remote_dma_selfring_smoke): the same device code on a one-rank ring
// whose peer is the card itself -- the barrier signalled twice to itself
// and waited for 2, the local copy into slot 0, one store through the
// peer-pointer path into slot `chunk` of the same buffer, its arrival
// signalled and waited for.
//
// Synchronisation.  Each rank owns, in a flag workspace on its card that is
// allocated once per mesh, one barrier slot for each rank of its ring and
// one arrival counter; its card owns one error word in pinned host memory
// mapped into every card's address space.  The host passes this gather's
// generation (one more than the last on the mesh) and the value the
// arrival counter must reach, so nothing is ever reset.  Comparisons are on
// the signed difference, so generations and counters wrap at 2^32 without
// harm as long as none lags its target by 2^31.
//   * Barrier: CTA 0 of a rank stores the generation into its slot of every
//     rank it will store into (release, system scope); every CTA waits until
//     each peer's slot of its own rank holds this generation or a later one
//     (acquire).  A rank's kernel running means the work queued before it on
//     that card's stream is done, so no peer writes into an output that the
//     caching allocator handed out while an earlier kernel still used the
//     memory.  A slot only moves forward when its peer enters a gather, so a
//     rank that timed out in an earlier gather never lets a later one pass
//     before every peer has entered it.
//   * Arrival: after its stores, a CTA fences at system scope and adds 1 to
//     the arrival counter of each peer it stored into; CTA 0 of a rank
//     returns only once its own counter has reached the target, so the
//     kernel ends after every byte of its output has landed.  A peer can add
//     to it only after it has passed this gather's barrier, so the counter
//     can lag its target (a timed-out gather) but never pass it early.
//   * Every spin is bounded by %globaltimer (nanoseconds): when it runs out
//     the CTA writes an error code into the card's error word and returns.
//     The host reads that word without waiting on a stream; a hang becomes
//     an error.
//   * Spinning CTAs need the CTAs they wait for to be resident: one
//     cooperative launch per card covers all that card's ranks
//     (blockIdx.y = local rank), its grid no larger than the card holds.
//
// Bound: bytes.  A call reads each segment once and writes it n times;
// stores of 16 bytes where the row and the pointers allow, bytes otherwise.
// No arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kMaxDst = 8;     // ranks of a ring (destinations of a rank)
constexpr int kMaxLocal = 8;   // ranks of one launch (on one card)
// int64 words of a rank's descriptor as the host packs it
constexpr int kDescWords = 7 + 4 * kMaxDst;

enum GatherError : unsigned { kErrNone = 0, kErrBarrier = 1, kErrArrival = 2 };

struct RankDesc {
  const uint8_t* src;              // (outer, row_bytes) contiguous
  unsigned* arr;                   // this rank's arrival counter
  int ndst, nsig, nwait;
  unsigned gen;                    // this gather's generation
  unsigned arr_target;             // the arrival counter's value at the end
  uint8_t* dst[kMaxDst];           // where the segment goes in each output
  unsigned* dst_flag[kMaxDst];     // the owner's arrival counter; null: local
  unsigned* signal[kMaxDst];       // this rank's slot in each peer's barrier
  unsigned* wait[kMaxDst];         // each peer's slot in this rank's barrier
};

struct GatherParams {
  RankDesc rank[kMaxLocal];
  long long outer;                 // rows of a segment
  long long row_bytes;             // bytes of a segment row (chunk * inner)
  long long dst_stride;            // bytes of an output row (n * row_bytes)
  unsigned* err;                   // this card's error word (host-mapped)
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void add_release(unsigned* flag) {
  asm volatile("red.release.sys.add.u32 [%0], %1;" ::"l"(flag), "r"(1u) : "memory");
}

__device__ __forceinline__ void store_release(unsigned* flag, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// Spin until *flag has reached target (wrap-safe); false on timeout.
__device__ bool wait_for(const unsigned* flag, unsigned target, unsigned long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while ((int)(load_acquire(flag) - target) < 0) {
    if (now_ns() - t0 > timeout_ns) return false;
    __nanosleep(64);
  }
  return true;
}

__device__ void report(unsigned* err, unsigned code) {
  *reinterpret_cast<volatile unsigned*>(err) = code;
  __threadfence_system();
}

template <bool kVec>
__device__ void copy_segment(const GatherParams& p, const RankDesc& r) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const long long rv = p.row_bytes >> 4, sv = p.dst_stride >> 4;
    const long long total = p.outer * rv;
    const uint4* s = reinterpret_cast<const uint4*>(r.src);
    for (long long i = first; i < total; i += step) {
      const uint4 v = s[i];
      const long long row = i / rv, at = row * sv + (i - row * rv);
      for (int d = 0; d < r.ndst; ++d) reinterpret_cast<uint4*>(r.dst[d])[at] = v;
    }
  } else {
    const long long total = p.outer * p.row_bytes;
    for (long long i = first; i < total; i += step) {
      const uint8_t v = r.src[i];
      const long long row = i / p.row_bytes, at = row * p.dst_stride + (i - row * p.row_bytes);
      for (int d = 0; d < r.ndst; ++d) r.dst[d][at] = v;
    }
  }
}

// One CTA's share of one rank's gather: barrier, stores, arrival.
template <bool kVec>
__device__ void gather_rank(const GatherParams& p, const RankDesc& r) {
  if (blockIdx.x == 0 && threadIdx.x < r.nsig) store_release(r.signal[threadIdx.x], r.gen);
  const bool entered =
      threadIdx.x >= r.nwait || wait_for(r.wait[threadIdx.x], r.gen, p.timeout_ns);
  if (!entered) report(p.err, kErrBarrier);
  if (!__syncthreads_and(entered)) return;
  copy_segment<kVec>(p, r);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int d = 0; d < r.ndst; ++d)
      if (r.dst_flag[d] != nullptr) add_release(r.dst_flag[d]);
    if (blockIdx.x == 0 && !wait_for(r.arr, r.arr_target, p.timeout_ns))
      report(p.err, kErrArrival);
  }
}

// Replaces simd_dct_tpu/dist/collectives.py:215 (gather_planes_remote).
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
ring_gather_kernel(const __grid_constant__ GatherParams p) {
  gather_rank<kVec>(p, p.rank[blockIdx.y]);
}

// Replaces simd_dct_tpu/dist/collectives.py:310 (remote_dma_selfring_smoke).
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
selfring_kernel(const __grid_constant__ GatherParams p) {
  gather_rank<kVec>(p, p.rank[blockIdx.y]);
}

bool unpack(const long long* desc, int local_ranks, GatherParams* p) {
  for (int k = 0; k < local_ranks; ++k) {
    const long long* w = desc + (long long)k * kDescWords;
    RankDesc& r = p->rank[k];
    r.src = reinterpret_cast<const uint8_t*>(w[0]);
    r.arr = reinterpret_cast<unsigned*>(w[1]);
    r.ndst = (int)w[2];
    r.nsig = (int)w[3];
    r.nwait = (int)w[4];
    r.gen = (unsigned)w[5];
    r.arr_target = (unsigned)w[6];
    if (r.ndst < 1 || r.ndst > kMaxDst || r.nsig < 0 || r.nsig > kMaxDst || r.nwait < 0 ||
        r.nwait > kMaxDst)
      return false;
    for (int d = 0; d < kMaxDst; ++d) {
      r.dst[d] = reinterpret_cast<uint8_t*>(w[7 + d]);
      r.dst_flag[d] = reinterpret_cast<unsigned*>(w[7 + kMaxDst + d]);
      r.signal[d] = reinterpret_cast<unsigned*>(w[7 + 2 * kMaxDst + d]);
      r.wait[d] = reinterpret_cast<unsigned*>(w[7 + 3 * kMaxDst + d]);
    }
  }
  return true;
}

template <bool kVec>
const void* kernel_of(int selfring) {
  return selfring ? (const void*)&selfring_kernel<kVec> : (const void*)&ring_gather_kernel<kVec>;
}

int launch(int selfring, const long long* desc, int local_ranks, int blocks, long long outer,
           long long row_bytes, long long dst_stride, int vec, void* err,
           unsigned long long timeout_ns, void* stream) {
  if (local_ranks < 1 || local_ranks > kMaxLocal || blocks < 1 || outer < 1 || row_bytes < 1 ||
      dst_stride < row_bytes || (vec && (row_bytes % 16 || dst_stride % 16)))
    return (int)cudaErrorInvalidValue;
  GatherParams p = {};
  if (!unpack(desc, local_ranks, &p)) return (int)cudaErrorInvalidValue;
  p.outer = outer;
  p.row_bytes = row_bytes;
  p.dst_stride = dst_stride;
  p.err = reinterpret_cast<unsigned*>(err);
  p.timeout_ns = timeout_ns;
  void* args[] = {&p};
  const void* fn = vec ? kernel_of<true>(selfring) : kernel_of<false>(selfring);
  // cooperative: every CTA of the grid is resident at once, or the launch
  // is refused, so no spinning CTA waits for one that cannot start
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks, local_ranks), dim3(kGatherThreads),
                                          args, 0, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// desc: local_ranks descriptors of kDescWords int64 each, as
// dist/collectives.py packs them.  blocks: CTAs per rank (the same for
// every rank of a ring, since arrival targets count them).  err: the
// card's error word, from sdct_host_words.  vec: 16-byte stores
// (row_bytes, dst_stride and every pointer 16-byte aligned).
int sdct_ring_gather(const long long* desc, int local_ranks, int blocks, long long outer,
                     long long row_bytes, long long dst_stride, int vec, void* err,
                     unsigned long long timeout_ns, void* stream) {
  return launch(0, desc, local_ranks, blocks, outer, row_bytes, dst_stride, vec, err, timeout_ns,
                stream);
}

int sdct_selfring(const long long* desc, int blocks, long long outer, long long row_bytes,
                  long long dst_stride, int vec, void* err, unsigned long long timeout_ns,
                  void* stream) {
  return launch(1, desc, 1, blocks, outer, row_bytes, dst_stride, vec, err, timeout_ns, stream);
}

// n zeroed u32 words of pinned host memory that every card can store into
// through the same pointer (mapped, portable; unified addressing makes the
// host pointer the device pointer), into *words.  Never freed: a kernel
// may report into a word after its host objects are gone.
int sdct_host_words(int n, void** words) {
  void* host = nullptr;
  void* dev = nullptr;
  cudaError_t e = cudaHostAlloc(&host, (size_t)n * 4, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e == cudaSuccess && dev != host) e = cudaErrorNotSupported;
  if (e != cudaSuccess) {
    cudaFreeHost(host);
    return (int)e;
  }
  for (int i = 0; i < n; ++i) static_cast<volatile unsigned*>(host)[i] = 0;
  *words = host;
  return 0;
}

// CTAs of either kernel that the current card holds at once (the most a
// cooperative launch takes), into *blocks.
int sdct_gather_capacity(int* blocks) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const void* fns[] = {kernel_of<true>(0), kernel_of<false>(0), kernel_of<true>(1),
                       kernel_of<false>(1)};
  int least = 1 << 30;
  for (const void* fn : fns) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kGatherThreads, 0);
    if (e != cudaSuccess) return (int)e;
    least = per_sm < least ? per_sm : least;
  }
  *blocks = least * sms;
  return 0;
}

// Let `device` store into `peer`'s memory (a mesh over several cards).
// Already enabled counts as success; a pair that cannot is an error.  The
// calling thread's current card is left as it was.
int sdct_enable_peer(int device, int peer) {
  int can = 0, prev = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"

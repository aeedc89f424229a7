// Interleaved static-table rANS decode for Hopper (sm_90a).
//
// Replaces the TPU kernel tse1m_tpu/cluster/kernels/rans.py:_rans_kernel
// (run by _rans_decode_pallas), with its decode tables (_decode_tables,
// built there by XLA before the call) built inside the kernel.
//
// One launch decodes up to kMaxLanes coded lanes, one block a lane.  A lane
// has up to four planes (one for a direct lane of <= 12-bit symbols, one
// per byte for a wider lane).  A plane is 32 interleaved rANS streams, lane
// k of a warp owning stream k, stepping ceil(n / 32) times:
//   s = slot_sym[x & 4095];  x = f[s] * (x >> 12) + (x & 4095) - cum[s];
//   if x < 2^16, x = (x << 16) | the next word of the shared stream,
// the streams that need a word taking them in stream order.  Symbol i of
// plane p lands in out[i] at bit 8 * p (byte planes) or whole (one plane).
//
// What bounds it on an H100: not bytes or operations.  At the main path's
// largest lane (507,704 symbols in 3 byte planes) the kernel moves about
// 3 MB and does some 2e7 integer operations, microseconds of the card's
// rates; but each plane is one chain of 15,866 dependent steps, so the
// kernel's time is steps x the latency of one step.  The previous design
// took ~406 cycles a step; switching its parts off one at a time showed the
// word path (register windows, two shuffles, refills) at ~126 cycles, the
// second dependent table load at ~82 and the global atomicOr at ~31.
// This design keeps one step to one shared load, a compare, a vote and
// two popc:
//   - one 64-bit table entry a slot: f - 1 and k = slot - cum[symbol] for
//     the update and the symbol in its low word (8 + 12 + 12 bits for an
//     alphabet of at most 256; a wider one keeps the symbol in the high
//     word), and the largest x >> 12 that still needs a word after the
//     update (floor((2^16 - 1 - k) / f)) in the high word.  The vote
//     compares x >> 12 against that bound, so it no longer waits on the
//     multiply-add, which runs beside it.  The table is built by a
//     scatter over symbol ranges (a symbol writes its f slots from its
//     exclusive cumulative start; symbols above 32 slots are written by
//     the whole warp), not by a search per slot;
//   - the word stream reaches shared memory through a ring of kStages
//     stages of 1 KB per plane, filled ahead of the chain by a producer
//     warp with 1-D bulk copies (cp.async.bulk, completion on an mbarrier;
//     no tensor map).  When the chain nears a stage, its warp turns the
//     stage's words into (entry of the word's slot, word) pairs in a pair
//     buffer of kPairChunks stages and hands the stage back.  A lane that
//     takes a word takes it with its next entry in one shared load at
//     (v + popc(vote & lanes below)) mod the buffer, so the table load
//     leaves the chain (a lane that takes no word loads its entry from the
//     table meanwhile);
//   - the steps run in batches with no branch inside: before a batch the
//     pair buffer holds the next 32 words of every step in it;
//   - no atomics: byte planes write disjoint bytes of the output, so each
//     plane stores its symbol as one plain byte store (a one-plane lane
//     stores the word); the wrapper zeroes the output.  The plane warps
//     never synchronise with each other;
//   - every coded lane of a call runs in one launch, side by side on
//     separate SMs, so the rep and counts chains of the delta metadata
//     overlap instead of running one after the other.
// Bulk copies need 16-byte aligned addresses and sizes: a plane's copies
// start at the aligned floor of its words and end at the aligned ceiling
// of their last byte (the same 16-byte granules, so no page is crossed),
// and the consumer skips the lead-in.  Precondition: each plane's
// frequencies sum to 2^12 (every frame entropy.encode_lane writes); the
// wrapper checks it where the frame is on the host.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_async.cuh"

namespace {

constexpr int kStreams = 32;
constexpr int kProbBits = 12;
constexpr int kSlots = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxPlanes = 4;
constexpr int kMaxLanes = 8;
constexpr int kStages = 4;
constexpr int kStageWords = 512;  // 1 KB stages
constexpr int kPairChunks = 4;     // stages of (entry, word) pairs a plane
constexpr int kPairWords = kPairChunks * kStageWords;
constexpr int kHeavy = 32;  // a symbol with more slots is written by the warp
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Lane {
  const uint16_t* words[kMaxPlanes];
  const uint32_t* x0[kMaxPlanes];
  const uint16_t* freqs[kMaxPlanes];
  int n_words[kMaxPlanes];
  uint32_t* out;
  int n;
  int n_planes;
  int alphabet;
  int byte_planes;  // 1: plane p is byte p of the output; 0: one plane
};

struct Lanes {
  Lane lane[kMaxLanes];
};

// ---- a plane's word stream, seen from 16-byte granules ----

struct Stream {
  const char* base;  // aligned floor of the words
  int lead;          // words between the floor and word 0
  int n_chunks;      // bulk copies of up to a stage
  int last_bytes;    // size of the last copy
};

__device__ __forceinline__ Stream stream_of(const uint16_t* words,
                                            int n_words) {
  constexpr int stage_bytes = 2 * kStageWords;
  Stream s;
  const uintptr_t a = reinterpret_cast<uintptr_t>(words);
  s.base = reinterpret_cast<const char*>(a & ~uintptr_t{15});
  s.lead = static_cast<int>((a & 15) >> 1);
  const int bytes = n_words ? (2 * (s.lead + n_words) + 15) & ~15 : 0;
  s.n_chunks = (bytes + stage_bytes - 1) / stage_bytes;
  s.last_bytes = bytes - (s.n_chunks - 1) * stage_bytes;
  return s;
}

// ---- the decode table ----

// A slot's entry.  Low word: f - 1 (bits 0-11) and k = slot - cum[s]
// (bits 12-23) for the update x' = f * (x >> 12) + k, and, for an
// alphabet of at most 256 symbols, the symbol (bits 24-31).  High word:
// the largest x >> 12 whose update needs a word, floor((2^16 - 1 - k) /
// f) (bits 0-15), and, for a wider alphabet (`kWide`), the symbol (bits
// 16-31).  In a pair the word takes bits 16-31 of the high word.
template <bool kWide>
__device__ __forceinline__ uint64_t make_entry(uint32_t sym, uint32_t f,
                                               uint32_t k) {
  const uint32_t last_q = (0xFFFFu - k) / f;
  const uint32_t lo = (f - 1u) | (k << 12) | (kWide ? 0u : sym << 24);
  const uint32_t hi = last_q | (kWide ? sym << 16 : 0u);
  return lo | (static_cast<uint64_t>(hi) << 32);
}

// table[slot] for every slot, by one warp: a warp scan gives each symbol's
// exclusive cumulative start, then each symbol writes its own f slots (or
// the warp writes them together, for a symbol of more than kHeavy slots).
template <bool kWide>
__device__ void build_table(uint64_t* table,
                            const uint16_t* __restrict__ freqs, int alphabet,
                            int lane) {
  uint32_t carry = 0;
  for (int s0 = 0; s0 < alphabet; s0 += kStreams) {
    const int s = s0 + lane;
    const uint32_t f = s < alphabet ? static_cast<uint32_t>(freqs[s]) : 0u;
    uint32_t incl = f;
#pragma unroll
    for (int d = 1; d < kStreams; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    const uint32_t cum = carry + incl - f;
    if (f <= static_cast<uint32_t>(kHeavy)) {
      for (uint32_t k = 0; k < f; ++k)
        if (cum + k < kSlots) table[cum + k] = make_entry<kWide>(s, f, k);
    }
    unsigned heavy = __ballot_sync(kFull, f > static_cast<uint32_t>(kHeavy));
    while (heavy) {
      const int h = __ffs(heavy) - 1;
      heavy &= heavy - 1;
      const uint32_t fh = __shfl_sync(kFull, f, h);
      const uint32_t ch = __shfl_sync(kFull, cum, h);
      for (uint32_t k = lane; k < fh; k += kStreams)
        if (ch + k < kSlots) table[ch + k] = make_entry<kWide>(s0 + h, fh, k);
    }
    carry += __shfl_sync(kFull, incl, kStreams - 1);
  }
  __syncwarp();
}

// ---- one plane, one warp ----

// One decode step of the warp.  State: x, q = x >> 12, e = the entry of
// x's slot and, for a wide alphabet, sym its symbol (else it sits in e).
// `kTail`: the last, partial step (lanes at i >= n keep their state and
// store nothing).  The vote needs only q and e's bound; the update runs
// beside it.  A lane that takes a word takes the entry of its next slot
// with it from the pair buffer; one that takes none loads its next entry
// from the table meanwhile, so the chain holds one shared load a step.
template <bool kBytes, bool kWide, bool kTail>
__device__ __forceinline__ void step(uint32_t& x, uint32_t& q, uint64_t& e,
                                     uint32_t& sym, int& v,
                                     const uint64_t* __restrict__ table,
                                     const uint64_t* __restrict__ pairs,
                                     unsigned below, bool act,
                                     unsigned char* __restrict__ out) {
  const uint32_t lo = static_cast<uint32_t>(e);
  const uint32_t hi = static_cast<uint32_t>(e >> 32);
  const bool need = (!kTail || act) && q <= (hi & 0xFFFFu);
  const unsigned vote = __ballot_sync(kFull, need);
  uint32_t xn = (lo & 0xFFFu) * q + (q + ((lo >> 12) & 0xFFFu));
  if (kTail && !act) xn = x;
  const uint64_t next = table[xn & (kSlots - 1)];
  const uint64_t pair = pairs[(v + __popc(vote & below)) & (kPairWords - 1)];
  if (!kTail || act) {
    const uint32_t s = kWide ? sym : lo >> 24;
    if (kBytes)
      *out = static_cast<unsigned char>(s);
    else
      *reinterpret_cast<uint32_t*>(out) = s;
  }
  const uint32_t w = static_cast<uint32_t>(pair >> 48);
  if (kWide)
    sym = need ? static_cast<uint32_t>(table[w & (kSlots - 1)] >> 48)
               : static_cast<uint32_t>(next >> 48);
  x = need ? (xn << 16) | w : xn;
  e = need ? pair : next;
  q = x >> kProbBits;
  v += __popc(vote);
}

// Words of one landed stage -> (entry of the word's slot, word) pairs at
// their place in the pair buffer; the stage goes back to the producer.
__device__ __forceinline__ void convert(int c, const uint16_t* ring,
                                        uint64_t* pairs, const uint64_t* table,
                                        uint64_t* full, uint64_t* empty,
                                        int lane) {
  bar_wait(&full[c % kStages], (c / kStages) & 1);
  const uint16_t* raw = ring + (c % kStages) * kStageWords;
  uint64_t* dst = pairs + (c % kPairChunks) * kStageWords;
#pragma unroll 8
  for (int j = lane; j < kStageWords; j += kStreams) {
    const uint32_t w = raw[j];
    dst[j] = (table[w & (kSlots - 1)] & ((uint64_t{1} << 48) - 1)) |
             (static_cast<uint64_t>(w) << 48);
  }
  __syncwarp();
  if (lane == 0) bar_arrive(&empty[c % kStages]);
}

template <bool kBytes, bool kWide>
__device__ void decode_plane(const Lane& L, int p, uint64_t* table,
                             uint16_t* ring, uint64_t* pairs, uint64_t* full,
                             uint64_t* empty, int lane) {
  build_table<kWide>(table, L.freqs[p], L.alphabet, lane);
  const Stream st = stream_of(L.words[p], L.n_words[p]);
  const unsigned below = (1u << lane) - 1u;
  const int n = L.n;
  const int full_steps = n / kStreams;
  // This lane's output word of the step, at byte p for a byte plane.
  unsigned char* out =
      reinterpret_cast<unsigned char*>(L.out + lane) + (kBytes ? p : 0);
  uint32_t x = L.x0[p][lane];
  uint32_t q = x >> kProbBits;
  uint64_t e = table[x & (kSlots - 1)];
  uint32_t sym = static_cast<uint32_t>(e >> 48);  // used when kWide
  int v = st.lead;     // words of the floor consumed so far
  int converted = 0;   // stages turned into pairs (and handed back)
  // Steps run in batches with no check inside: before a batch the pairs
  // cover [v, v + 32 * batch), a step taking at most 32 words, and reach
  // at least a stage past v, so a batch is at least 16 steps long.
  for (int t = 0; t < full_steps;) {
    while (converted < st.n_chunks &&
           converted * kStageWords < v + kStageWords + kStreams)
      convert(converted++, ring, pairs, table, full, empty, lane);
    const int avail = converted == st.n_chunks
                          ? full_steps - t
                          : (converted * kStageWords - v) / kStreams;
    const int end = t + min(avail, full_steps - t);
    for (; t < end; ++t) {
      step<kBytes, kWide, false>(x, q, e, sym, v, table, pairs, below, true,
                                 out);
      out += 4 * kStreams;
    }
  }
  if (n % kStreams) {
    while (converted < st.n_chunks && converted * kStageWords < v + kStreams)
      convert(converted++, ring, pairs, table, full, empty, lane);
    step<kBytes, kWide, true>(x, q, e, sym, v, table, pairs, below,
                              full_steps * kStreams + lane < n, out);
  }
  // A valid stream has consumed every stage by now.  Take and hand back
  // whatever is left anyway, so the producer always finishes and no copy
  // is in flight when the block exits.
  for (; converted < st.n_chunks; ++converted) {
    bar_wait(&full[converted % kStages], (converted / kStages) & 1);
    if (lane == 0) bar_arrive(&empty[converted % kStages]);
  }
}

// The producer: one thread keeps every plane's ring full, polling the
// stages its consumers hand back.
__device__ void produce(const Lane& L, uint16_t* rings, uint64_t* full,
                        uint64_t* empty) {
  Stream st[kMaxPlanes];
  int next[kMaxPlanes];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    st[p] = stream_of(p < L.n_planes ? L.words[p] : nullptr,
                      p < L.n_planes ? L.n_words[p] : 0);
    next[p] = 0;
  }
  for (;;) {
    bool left = false, issued = false;
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      const int c = next[p];
      if (p >= L.n_planes || c >= st[p].n_chunks) continue;
      left = true;
      const int s = c % kStages;
      uint64_t* e = &empty[p * kStages + s];
      if (c >= kStages && !bar_test(e, ((c / kStages) - 1) & 1)) continue;
      const uint32_t bytes =
          c == st[p].n_chunks - 1 ? st[p].last_bytes : 2 * kStageWords;
      bulk_load(rings + (p * kStages + s) * kStageWords,
                st[p].base + static_cast<size_t>(c) * 2 * kStageWords, bytes,
                &full[p * kStages + s]);
      next[p] = c + 1;
      issued = true;
    }
    if (!left) break;
    if (!issued) __nanosleep(64);
  }
}

// Dynamic shared memory of one block: the barriers, then each plane's pair
// buffer, word ring and table.
constexpr int kBarBytes = 2 * kMaxPlanes * kStages * 8;
constexpr int kPlaneBytes =
    kPairWords * 8 + kStages * kStageWords * 2 + kSlots * 8;

template <bool kBytes, bool kWide>
__device__ void run_lane(const Lane& L, unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxPlanes * kStages;
  uint64_t* pairs = reinterpret_cast<uint64_t*>(smem + kBarBytes);
  uint64_t* tables = pairs + L.n_planes * kPairWords;
  uint16_t* rings = reinterpret_cast<uint16_t*>(tables + L.n_planes * kSlots);
  const int warp = threadIdx.x / kStreams;
  const int lane = threadIdx.x % kStreams;
  const int producer = blockDim.x / kStreams - 1;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kMaxPlanes * kStages; ++b) {
      bar_init(&full[b], 1);
      bar_init(&empty[b], 1);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (warp == producer) {
    if (lane == 0) produce(L, rings, full, empty);
  } else if (warp < L.n_planes) {
    decode_plane<kBytes, kWide>(
        L, warp, tables + warp * kSlots, rings + warp * kStages * kStageWords,
        pairs + warp * kPairWords, full + warp * kStages,
        empty + warp * kStages, lane);
  }
}

__global__ void rans_decode_kernel(Lanes lanes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane& L = lanes.lane[blockIdx.x];
  if (L.byte_planes)
    run_lane<true, false>(L, smem);
  else if (L.alphabet > 256)
    run_lane<false, true>(L, smem);
  else
    run_lane<false, false>(L, smem);
}

}  // namespace

// Plain C++ entry point for the binding: enqueues one launch on `stream`
// (one block a lane: a consumer warp per plane of the widest lane and a
// producer warp) and returns the launch's error code without
// synchronising.  Plane p of lane l: words[l][p] (n_words[l][p] uint16
// words), x0[l][p] (32 states), freqs[l][p] (alphabet[l] frequencies).
cudaError_t tse1m_launch_rans_decode_lanes(
    int n_lanes, const int* n_planes, const uint16_t* const* const* words,
    const int* const* n_words, const uint32_t* const* const* x0,
    const uint16_t* const* const* freqs, const int* alphabet, const int* n,
    const int* byte_planes, uint32_t* const* out, cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes) return cudaErrorInvalidValue;
  Lanes lanes{};
  int max_planes = 1;
  size_t smem = 0;
  for (int l = 0; l < n_lanes; ++l) {
    Lane& L = lanes.lane[l];
    if (n_planes[l] < 1 || n_planes[l] > kMaxPlanes)
      return cudaErrorInvalidValue;
    for (int p = 0; p < n_planes[l]; ++p) {
      L.words[p] = words[l][p];
      L.n_words[p] = n_words[l][p];
      L.x0[p] = x0[l][p];
      L.freqs[p] = freqs[l][p];
    }
    L.out = out[l];
    L.n = n[l];
    L.n_planes = n_planes[l];
    L.alphabet = alphabet[l];
    L.byte_planes = byte_planes[l];
    max_planes = n_planes[l] > max_planes ? n_planes[l] : max_planes;
    const size_t need = kBarBytes + n_planes[l] * kPlaneBytes;
    smem = need > smem ? need : smem;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for a later launch's check to find
    return err;
  }
  rans_decode_kernel<<<n_lanes, kStreams * (max_planes + 1), smem, stream>>>(
      lanes);
  return cudaGetLastError();
}

// Interleaved static-table rANS decode for Hopper (sm_90a).
//
// Replaces the TPU kernel tse1m_tpu/cluster/kernels/rans.py:_rans_kernel
// (run by _rans_decode_pallas), with its decode tables (_decode_tables,
// built there by XLA before the call) built inside the kernel.
//
// One launch decodes one coded lane: up to four planes (one for a direct
// lane of <= 12-bit symbols, one per byte for a wider lane), one warp per
// plane.  A plane is 32 interleaved rANS streams, lane k of the warp owning
// stream k, stepping ceil(n / 32) times:
//   s = slot_sym[x & 4095];  x = f[s] * (x >> 12) + (x & 4095) - cum[s];
//   if x < 2^16, x = (x << 16) | the next word of the shared stream,
// the streams that need a word taking them in stream order.  Symbol i of the
// plane lands at out[i] |= s << (shift * plane).
//
// What bounds it on an H100: not bytes or operations.  At the main path's
// largest lane (507,704 symbols in 3 byte planes) the kernel moves about
// 3 MB and does some 2e7 integer operations, microseconds of the card's
// rates; but each plane is one chain of 15,866 dependent steps, and each
// step waits on its own two table reads, a warp vote, the word fetch and
// the state update.  So the design keeps every step's latency short:
//   - the tables live in shared memory (slot -> symbol as 4,096 uint16, and
//     per symbol its frequency and exclusive cumulative frequency packed in
//     one uint32: 24 KB), built by the warp from the shipped frequencies
//     with a warp scan and a binary search per slot;
//   - the shared word pointer advances by __popc of the warp's need vote,
//     and each needing lane's word index is __popc(vote & lanes below it);
//   - the word stream is read ahead in two register windows of 128 words
//     (four words a lane, one coalesced 8-byte load each) and picked with
//     __shfl_sync, so no step waits on device memory unless the window
//     loaded 128 words earlier has not arrived;
//   - symbols leave with a fire-and-forget atomicOr into the output the
//     wrapper zeroed, which also combines the byte planes exactly.
// Planes run side by side on separate SMs.  Simple and right first: one
// warp per plane leaves the card nearly idle, and splitting a plane's chain
// needs a different wire format.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStreams = 32;
constexpr int kProbBits = 12;
constexpr int kSlots = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxPlanes = 4;
constexpr int kWinWords = 4 * kStreams;  // words in one register window
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Planes {
  const uint16_t* words[kMaxPlanes];
  const uint32_t* x0[kMaxPlanes];
  const uint16_t* freqs[kMaxPlanes];
  int n_words[kMaxPlanes];
};

// This lane's four words of the window [base, base + kWinWords): words
// base + 4 * lane .. + 3 as two little-endian pairs.  Words past the end of
// the stream read as 0 (a valid stream never consumes them).  `words` is
// 8-byte aligned (the wrapper checks), so a full quad is one 8-byte load.
__device__ __forceinline__ uint2 load_window(const uint16_t* __restrict__ words,
                                             int n_words, int base,
                                             int lane) {
  const int i = base + 4 * lane;
  if (i + 4 <= n_words)
    return __ldg(reinterpret_cast<const uint2*>(words + i));
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = i + j < n_words ? static_cast<uint32_t>(__ldg(words + i + j)) : 0u;
  return make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
}

// Word j (0 <= j < kWinWords) of a window, read from the lane that holds
// it.  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t pick(uint2 win, int j) {
  const uint32_t lo = __shfl_sync(kFull, win.x, j >> 2);
  const uint32_t hi = __shfl_sync(kFull, win.y, j >> 2);
  const uint32_t pair = (j & 2) ? hi : lo;
  return (j & 1) ? pair >> 16 : pair & 0xFFFFu;
}

__global__ void __launch_bounds__(kStreams)
rans_decode_kernel(Planes planes, int n, int alphabet, int shift_step,
                   uint32_t* __restrict__ out) {
  __shared__ uint16_t slot_sym[kSlots];
  __shared__ uint32_t sym_fc[kSlots];  // freq | exclusive cum << 16
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const uint16_t* __restrict__ words = planes.words[p];
  const uint16_t* __restrict__ freqs = planes.freqs[p];
  const int n_words = planes.n_words[p];

  // Exclusive cumulative frequencies: a warp scan over 32 symbols at a time.
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
    if (s < alphabet) sym_fc[s] = f | ((carry + incl - f) << 16);
    carry += __shfl_sync(kFull, incl, kStreams - 1);
  }
  __syncwarp();
  // slot -> symbol: the first symbol whose inclusive cumulative frequency
  // exceeds the slot (searchsorted, side right), kept inside the alphabet.
  for (int slot = lane; slot < kSlots; slot += kStreams) {
    int lo = 0;
    int hi = alphabet;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const uint32_t fc = sym_fc[mid];
      if ((fc >> 16) + (fc & 0xFFFFu) > static_cast<uint32_t>(slot))
        hi = mid;
      else
        lo = mid + 1;
    }
    slot_sym[slot] = static_cast<uint16_t>(min(lo, alphabet - 1));
  }
  __syncwarp();

  const unsigned below = (1u << lane) - 1u;
  const int shift = shift_step * p;
  uint32_t x = planes.x0[p][lane];
  int ptr = 0;   // words consumed by the warp so far
  int base = 0;  // first word of window w0; w1 follows it
  uint2 w0 = load_window(words, n_words, 0, lane);
  uint2 w1 = load_window(words, n_words, kWinWords, lane);
  const int steps = (n + kStreams - 1) / kStreams;
  for (int t = 0; t < steps; ++t) {
    const int i = t * kStreams + lane;
    const bool act = i < n;
    const uint32_t slot = x & (kSlots - 1);
    const uint32_t s = slot_sym[slot];
    const uint32_t fc = sym_fc[s];
    if (act) {
      x = (fc & 0xFFFFu) * (x >> kProbBits) + slot - (fc >> 16);
      atomicOr(out + i, s << shift);
    }
    const bool need = act && x < kRansL;
    const unsigned vote = __ballot_sync(kFull, need);
    if (vote == 0) continue;
    // ptr - base < kWinWords on entry, so j < 2 * kWinWords.
    const int taken = __popc(vote);
    const int j = ptr - base + __popc(vote & below);
    uint32_t w = pick(w0, j & (kWinWords - 1));
    if (ptr - base + taken > kWinWords) {  // some lane reads from w1
      const uint32_t w_next = pick(w1, j & (kWinWords - 1));
      if (j >= kWinWords) w = w_next;
    }
    if (need) x = (x << 16) | w;
    ptr += taken;
    if (ptr - base >= kWinWords) {
      base += kWinWords;
      w0 = w1;
      w1 = load_window(words, n_words, base + kWinWords, lane);
    }
  }
}

}  // namespace

// Plain C++ entry point for the binding: enqueues one launch on `stream`
// (one block of one warp per plane) and returns without synchronising.  The
// caller checks the launch.
void tse1m_launch_rans_decode(int n_planes, const uint16_t* const* words,
                              const int* n_words, const uint32_t* const* x0,
                              const uint16_t* const* freqs, int alphabet,
                              int n, int shift_step, uint32_t* out,
                              cudaStream_t stream) {
  Planes planes{};
  for (int p = 0; p < n_planes && p < kMaxPlanes; ++p) {
    planes.words[p] = words[p];
    planes.n_words[p] = n_words[p];
    planes.x0[p] = x0[p];
    planes.freqs[p] = freqs[p];
  }
  rans_decode_kernel<<<n_planes, kStreams, 0, stream>>>(planes, n, alphabet,
                                                        shift_step, out);
}

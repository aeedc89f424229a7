// Exact agreement-count top-k of a query batch over one store chunk, for
// Hopper (sm_90a).
//
// Replaces tse1m_tpu/cluster/kernels/score.py:_score_topk_kernel
// (_topk_chunk_pallas):
//   count[q, c] = sum_h (qsig[q, h] == s_t[h, c]), -1 on padding columns
//                 (rowids[c] == ROW_INF);
//   state out   = the exact top-k of (the incoming [Qp, K_PAD] state's slots
//                 with a count >= 0) and (the chunk's columns), ranked by
//                 (-count, ascending row); every other slot (-1, ROW_INF).
// Rows are unique and the rank is a total order, so the result equals the
// TPU kernel's serial tile loop (once its exhausted slots, which hold
// negative counts and arbitrary rows, read as (-1, ROW_INF)) whatever the
// tiling.  Columns must hold ascending rows (padding columns anywhere), as
// the chunk staging lays them out: ties are taken in column order.
//
// Two passes:
//  1. topk_count_kernel, grid (column tiles, groups of kQG queries).  The
//     block keeps its queries' signatures in shared memory as [H][kQG]
//     (16-byte broadcast reads); each thread walks columns, reads
//     s_t[h, c] coalesced (the store is transposed) and keeps kQG counts in
//     registers.  Counts go to an int16 scratch [Qp, Np], and a histogram
//     of the count values (H + 1 bins a query) is gathered in shared memory
//     (warp-aggregated by __match_any_sync) and added into [Qp, H + 1].
//  2. topk_select_kernel, one block a query.  From the histogram: the count
//     c* at which the top k end, and how many ties `need` at c* are taken.
//     The block scans the query's counts in column order, takes every
//     column above c* (in any order) and the first `need` columns at c*
//     (a block-wide prefix of the tie flags, only while ties are wanted),
//     then ranks the taken columns (<= k) and the incoming state's valid
//     slots (<= K_PAD) against each other (a candidate's rank is the number
//     that beat it) and writes them in rank order.
//
// What bounds it on an H100 SXM: operations.  Q x N x H compares and as
// many adds: at Q = 64 over 1,000,000 rows at H = 128, 8.2e9 of each, 0.49
// ms with compare and add issuing side by side on two integer pipes
// (16.75e12 a second each), against 516 MB of inputs read once, 0.154 ms at
// 3.35 TB/s.  The design shares each s_t load among kQG = 16 queries, so
// the store is read Qp / 16 times (4 times at Qp = 64: 2 GB, ~0.6 ms of
// HBM time: the read amplification a later PR can cut), and the counts
// leave as 2 bytes a (query, row), read back once by pass 2.
// Simple and right first; tile shapes are not tuned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQG = 16;                // queries a count block
constexpr int kCountThreads = 256;
constexpr int kColsPerBlock = 2048;    // columns a count block
constexpr int kSelThreads = 1024;
constexpr int kPerThread = 8;          // consecutive columns a select thread
constexpr int kKPad = 128;             // state slots a query (K_PAD)
constexpr int kRowInf = 0x7FFFFFFF;    // ROW_INF

__global__ void __launch_bounds__(kCountThreads)
topk_count_kernel(const uint32_t* __restrict__ q, int qp, int h,
                  const uint32_t* __restrict__ s_t,
                  const int* __restrict__ rowids, int np,
                  int16_t* __restrict__ counts, int* __restrict__ hist) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;                                    // [h][kQG]
  int* lh = reinterpret_cast<int*>(smem + h * kQG);       // [kQG][h + 1]
  const int q0 = blockIdx.y * kQG;
  const int nq = min(kQG, qp - q0);
  for (int e = threadIdx.x; e < h * kQG; e += blockDim.x) {
    const int hh = e / kQG;
    const int g = e - hh * kQG;
    qs[e] = g < nq ? q[static_cast<size_t>(q0 + g) * h + hh] : 0u;
  }
  for (int e = threadIdx.x; e < kQG * (h + 1); e += blockDim.x) lh[e] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kColsPerBlock;
  const int c1 = min(np, c0 + kColsPerBlock);
  // The loop runs alike in every thread (warp-wide match below); threads
  // past the tile's end re-read its last column and count nothing.
  for (int cb = c0; cb < c1; cb += kCountThreads) {
    const int c = cb + static_cast<int>(threadIdx.x);
    const bool in_tile = c < c1;
    const int cc = in_tile ? c : c1 - 1;
    int cnt[kQG];
#pragma unroll
    for (int g = 0; g < kQG; ++g) cnt[g] = 0;
    const uint32_t* col = s_t + cc;
#pragma unroll 4
    for (int hh = 0; hh < h; ++hh) {
      const uint32_t v = col[static_cast<size_t>(hh) * np];
      const uint4* qv = reinterpret_cast<const uint4*>(qs + hh * kQG);
#pragma unroll
      for (int g4 = 0; g4 < kQG / 4; ++g4) {
        const uint4 w = qv[g4];
        cnt[4 * g4 + 0] += v == w.x;
        cnt[4 * g4 + 1] += v == w.y;
        cnt[4 * g4 + 2] += v == w.z;
        cnt[4 * g4 + 3] += v == w.w;
      }
    }
    const bool valid = in_tile && rowids[cc] != kRowInf;
#pragma unroll
    for (int g = 0; g < kQG; ++g) {
      if (g < nq) {
        if (in_tile)
          counts[static_cast<size_t>(q0 + g) * np + c] =
              static_cast<int16_t>(valid ? cnt[g] : -1);
        // One shared atomic per distinct count value in the warp.
        const int key = valid ? cnt[g] : -1;
        const unsigned same = __match_any_sync(0xFFFFFFFFu, key);
        if (key >= 0 && lane == __ffs(same) - 1)
          atomicAdd(&lh[g * (h + 1) + key], __popc(same));
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * (h + 1); e += blockDim.x) {
    if (lh[e]) {
      const int g = e / (h + 1);
      atomicAdd(&hist[static_cast<size_t>(q0 + g) * (h + 1) + (e - g * (h + 1))],
                lh[e]);
    }
  }
}

// Exclusive prefix of x over the block; `total` gets the block's sum.
// warp_tot holds 33 ints.  Every thread of the block calls it.
__device__ void block_exclusive_scan(int x, int* excl, int* total,
                                     int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const int t = lane < nw ? warp_tot[lane] : 0;
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_tot[lane] = s - t;
    if (lane == 31) warp_tot[32] = s;
  }
  __syncthreads();
  *excl = warp_tot[warp] + incl - x;
  *total = warp_tot[32];
}

__device__ __forceinline__ bool beats(int ca, int ra, int cb, int rb) {
  return ca > cb || (ca == cb && ra < rb);
}

__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const int16_t* __restrict__ counts,
                   const int* __restrict__ hist, int h, int np,
                   const int* __restrict__ rowids,
                   const int* __restrict__ topc_in,
                   const int* __restrict__ topr_in, int k,
                   int* __restrict__ topc_out, int* __restrict__ topr_out) {
  __shared__ int cand_c[2 * kKPad];
  __shared__ int cand_r[2 * kKPad];
  __shared__ int out_c[kKPad];
  __shared__ int out_r[kKPad];
  __shared__ int warp_tot[33];
  __shared__ int s_cstar, s_need, s_n, s_ties;
  const int qi = blockIdx.x;
  if (threadIdx.x == 0) {
    const int* hq = hist + static_cast<size_t>(qi) * (h + 1);
    int total = 0;
    for (int c = 0; c <= h; ++c) total += hq[c];
    const int target = min(k, total);
    int cstar = -1, need = 0, acc = 0;
    for (int c = h; target > 0 && c >= 0; --c) {
      if (acc + hq[c] >= target) {
        cstar = c;
        need = target - acc;
        break;
      }
      acc += hq[c];
    }
    s_cstar = cstar;
    s_need = need;
    s_n = 0;
    s_ties = 0;
  }
  if (threadIdx.x < kKPad) {
    out_c[threadIdx.x] = -1;
    out_r[threadIdx.x] = kRowInf;
  }
  __syncthreads();
  const int cstar = s_cstar;
  const int need = s_need;
  if (cstar >= 0) {
    const int16_t* cq = counts + static_cast<size_t>(qi) * np;
    for (int base = 0; base < np; base += kSelThreads * kPerThread) {
      const int c0 = base + static_cast<int>(threadIdx.x) * kPerThread;
      int v[kPerThread];
      int n_ties = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        v[j] = c0 + j < np ? cq[c0 + j] : -1;
        if (v[j] > cstar) {
          const int slot = atomicAdd(&s_n, 1);
          cand_c[slot] = v[j];
          cand_r[slot] = rowids[c0 + j];
        }
        n_ties += v[j] == cstar;
      }
      // Every thread read s_ties after the last barrier; the branch is
      // taken by the whole block or by none.
      const int taken = s_ties;
      if (taken < need) {
        int off, total;
        block_exclusive_scan(n_ties, &off, &total, warp_tot);
        int rank = taken + off;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          if (v[j] == cstar) {
            if (rank < need) {
              const int slot = atomicAdd(&s_n, 1);
              cand_c[slot] = v[j];
              cand_r[slot] = rowids[c0 + j];
            }
            ++rank;
          }
        }
        if (threadIdx.x == 0) s_ties = taken + total;
      }
      __syncthreads();
    }
  }
  // The incoming state's valid slots join the candidates.
  if (threadIdx.x < kKPad) {
    const size_t at = static_cast<size_t>(qi) * kKPad + threadIdx.x;
    const int c = topc_in[at];
    if (c >= 0) {
      const int slot = atomicAdd(&s_n, 1);
      cand_c[slot] = c;
      cand_r[slot] = topr_in[at];
    }
  }
  __syncthreads();
  const int m = s_n;
  if (threadIdx.x < m) {
    const int c = cand_c[threadIdx.x];
    const int r = cand_r[threadIdx.x];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += beats(cand_c[j], cand_r[j], c, r);
    if (rank < k) {
      out_c[rank] = c;
      out_r[rank] = r;
    }
  }
  __syncthreads();
  if (threadIdx.x < kKPad) {
    const size_t at = static_cast<size_t>(qi) * kKPad + threadIdx.x;
    topc_out[at] = out_c[threadIdx.x];
    topr_out[at] = out_r[threadIdx.x];
  }
}

}  // namespace

// Plain C++ entry point for the binding: enqueues the two passes on
// `stream` and returns without synchronising; `hist` must arrive zeroed.
// The caller checks the launches.
cudaError_t tse1m_launch_topk_chunk(const uint32_t* q, int qp, int h,
                                    const uint32_t* s_t, const int* rowids,
                                    int np, const int* topc_in,
                                    const int* topr_in, int k,
                                    int16_t* counts, int* hist, int* topc_out,
                                    int* topr_out, cudaStream_t stream) {
  if (np > 0) {
    const size_t smem =
        sizeof(uint32_t) * h * kQG + sizeof(int) * kQG * (h + 1);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(topk_count_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const dim3 grid((np + kColsPerBlock - 1) / kColsPerBlock,
                    (qp + kQG - 1) / kQG);
    topk_count_kernel<<<grid, kCountThreads, smem, stream>>>(
        q, qp, h, s_t, rowids, np, counts, hist);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  topk_select_kernel<<<qp, kSelThreads, 0, stream>>>(
      counts, hist, h, np, rowids, topc_in, topr_in, k, topc_out, topr_out);
  return cudaGetLastError();
}

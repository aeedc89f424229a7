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
//  1. topk_count_kernel, a persistent grid of one block an SM (query
//     groups of kQG on grid.y).  The block keeps its group's signatures in
//     shared memory as [H][kQG] and walks column tiles of kTC columns.  A
//     producer warp stages each tile through a ring of kStages stages of
//     kRows hashes x kTC columns with 1-D bulk copies (cp.async.bulk, one
//     per hash row: kTC contiguous columns of s_t; completion on an
//     mbarrier).  Each of the kCountWarps consumer warps owns 4 queries and
//     every column of the tile: a lane counts 4 queries x 8 columns in
//     registers from three 16-byte shared loads a hash (one broadcast of
//     the 4 query values, two of 4 columns each).  Counts go to an int16
//     scratch [Qp, Np] as 8-byte stores, and a histogram of the count
//     values (H + 1 bins a query) is gathered in shared memory (warp-
//     aggregated by __match_any_sync) and added into [Qp, H + 1] once a
//     block.
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
// (16.75e12 a second each), 0.98 ms on one, against 516 MB of inputs read
// once, 0.154 ms at 3.35 TB/s.  The previous count pass shared each s_t
// load among 16 queries, so it read the store Qp / 16 times (2 GB at Qp = 64)
// with one 4-byte load a thread a hash, few of them in flight.  This one
// reads the store once per group of kQG = 64 queries (once at Qp <= 64),
// ahead of the counting through the ring, and feeds 32 compare-and-add
// pairs from three shared loads, the compare on the ALU pipe and the add
// on the FMA pipe (count_eq), so the two integer pipes, not the loads, set
// its pace.  The bulk copies need 16-byte aligned rows: Np a multiple of 4
// and s_t 16-byte aligned (the wrapper pads a chunk that is not).  The
// select pass reads the counts once (2 bytes a (query, row)).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQG = 64;                // queries a count block
constexpr int kTC = 256;               // columns a tile
constexpr int kRows = 32;              // hashes a stage
constexpr int kStages = 3;
constexpr int kCountWarps = kQG / 4;   // 4 queries a consumer warp
constexpr int kCountThreads = (kCountWarps + 1) * 32;
constexpr int kSelThreads = 1024;
constexpr int kPerThread = 8;          // consecutive columns a select thread
constexpr int kKPad = 128;             // state slots a query (K_PAD)
constexpr int kRowInf = 0x7FFFFFFF;    // ROW_INF
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBarBytes = 128;         // the ring's 2 x kStages mbarriers
constexpr int kStageBytes = kRows * kTC * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// c += (a == b), as one compare on the ALU pipe and one predicated
// multiply-add by `unit` (1, a kernel argument, so the compiler cannot
// fold it into an add) on the FMA pipe.  A plain `c += a == b` compiles to
// three instructions, all but one on the ALU pipe.
__device__ __forceinline__ void count_eq(int& c, uint32_t a, uint32_t b,
                                         uint32_t unit) {
  asm("{\n .reg .pred p;\n setp.eq.u32 p, %1, %2;\n"
      " @p mad.lo.u32 %0, %3, %3, %0;\n}"
      : "+r"(c)
      : "r"(a), "r"(b), "r"(unit));
}

// Shared memory of a count block at H hashes.
__host__ __device__ constexpr size_t count_smem(int h) {
  return kBarBytes + static_cast<size_t>(kStages) * kStageBytes +
         sizeof(uint32_t) * h * kQG + sizeof(int) * kQG * (h + 1);
}

__global__ void __launch_bounds__(kCountThreads, 1)
topk_count_kernel(const uint32_t* __restrict__ q, int qp, int h,
                  const uint32_t* __restrict__ s_t,
                  const int* __restrict__ rowids, int np,
                  int16_t* __restrict__ counts, int* __restrict__ hist,
                  uint32_t unit) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kBarBytes);
  uint32_t* qs = ring + kStages * kRows * kTC;             // [h][kQG]
  int* lh = reinterpret_cast<int*>(qs + h * kQG);          // [kQG][h + 1]
  const int q0 = blockIdx.y * kQG;
  const int nq = min(kQG, qp - q0);
  for (int e = threadIdx.x; e < h * kQG; e += blockDim.x) {
    const int hh = e / kQG;
    const int g = e - hh * kQG;
    qs[e] = g < nq ? q[static_cast<size_t>(q0 + g) * h + hh] : 0u;
  }
  for (int e = threadIdx.x; e < kQG * (h + 1); e += blockDim.x) lh[e] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kCountWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (np + kTC - 1) / kTC;
  if (warp == kCountWarps) {
    // Producer: one bulk copy a hash row of each stage, lane r copying
    // row r; lane 0 first waits for the stage and announces its bytes.
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int c0 = tile * kTC;
      const int cols = min(kTC, np - c0);
      for (int h0 = 0; h0 < h; h0 += kRows, ++it) {
        const int rows = min(kRows, h - h0);
        const int s = it % kStages;
        if (lane == 0) {
          if (it >= kStages) bar_wait(&empty[s], ((it / kStages) - 1) & 1);
          bar_expect(&full[s], static_cast<uint32_t>(rows * cols * 4));
        }
        __syncwarp();
        if (lane < rows)
          bulk_load(ring + (s * kRows + lane) * kTC,
                    s_t + static_cast<size_t>(h0 + lane) * np + c0,
                    static_cast<uint32_t>(cols * 4), &full[s]);
      }
    }
  } else {
    // Consumer warp: queries 4 * warp .. + 3 of the group against every
    // column of the tile; lane owns columns 4 * lane + j and 128 + 4 * lane
    // + j (j < 4), so each 16-byte column load of the warp is contiguous.
    const bool active = 4 * warp < nq;
    const uint4* qv4 = reinterpret_cast<const uint4*>(qs) + warp;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int c0 = tile * kTC;
      int cnt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) cnt[i][j] = 0;
      for (int h0 = 0; h0 < h; h0 += kRows, ++it) {
        const int rows = min(kRows, h - h0);
        const int s = it % kStages;
        bar_wait(&full[s], (it / kStages) & 1);
        if (active) {
          const uint4* col4 =
              reinterpret_cast<const uint4*>(ring + s * kRows * kTC) + lane;
#pragma unroll 4
          for (int r = 0; r < rows; ++r) {
            const uint4 w = qv4[(h0 + r) * (kQG / 4)];
            const uint4 a = col4[r * (kTC / 4)];
            const uint4 b = col4[r * (kTC / 4) + 32];
            const uint32_t qv[4] = {w.x, w.y, w.z, w.w};
            const uint32_t cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                count_eq(cnt[i][j], qv[i], cv[j], unit);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
      }
      if (!active) continue;
      // Epilogue: int16 counts (-1 on padding columns) as one 8-byte store
      // a query and column quad; histogram of the valid counts.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + 128 * half + 4 * lane;
        const bool in_tile = c < np;  // np and c are multiples of 4
        bool valid[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          valid[j] = in_tile && __ldg(rowids + c + j) != kRowInf;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = 4 * warp + i;
          if (g >= nq) continue;
          int v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = valid[j] ? cnt[i][4 * half + j] : -1;
          if (in_tile) {
            const uint2 packed = make_uint2(
                (static_cast<uint32_t>(v[0]) & 0xFFFFu) |
                    (static_cast<uint32_t>(v[1]) << 16),
                (static_cast<uint32_t>(v[2]) & 0xFFFFu) |
                    (static_cast<uint32_t>(v[3]) << 16));
            *reinterpret_cast<uint2*>(
                counts + static_cast<size_t>(q0 + g) * np + c) = packed;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // One shared atomic per distinct count value in the warp.
            const unsigned same = __match_any_sync(kFull, v[j]);
            if (v[j] >= 0 && lane == __ffs(same) - 1)
              atomicAdd(&lh[g * (h + 1) + v[j]], __popc(same));
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * (h + 1); e += blockDim.x) {
    if (lh[e]) {
      const int g = e / (h + 1);
      atomicAdd(
          &hist[static_cast<size_t>(q0 + g) * (h + 1) + (e - g * (h + 1))],
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

// Plain C++ entry point for the binding: enqueues the passes named in
// `passes` (1: count, 2: select, 3: both, as every caller but a timing
// harness asks) on `stream` and returns without synchronising; `hist` must
// arrive zeroed, `s_t` 16-byte aligned with `np` a multiple of 4.  Returns
// the launches' error code (cudaErrorInvalidValue for an H whose count block
// does not fit in shared memory: count_smem(h)).
cudaError_t tse1m_launch_topk_chunk(const uint32_t* q, int qp, int h,
                                    const uint32_t* s_t, const int* rowids,
                                    int np, const int* topc_in,
                                    const int* topr_in, int k,
                                    int16_t* counts, int* hist, int* topc_out,
                                    int* topr_out, int passes,
                                    cudaStream_t stream) {
  if (np % 4 || reinterpret_cast<uintptr_t>(s_t) % 16)
    return cudaErrorInvalidValue;
  if (np > 0 && (passes & 1)) {
    int dev = 0, n_sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    // An H whose count block needs more shared memory than a block may
    // opt into is refused here.
    const size_t smem = count_smem(h);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(topk_count_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for a later launch's check to find
      return err;
    }
    const int groups = (qp + kQG - 1) / kQG;
    const int n_tiles = (np + kTC - 1) / kTC;
    const int per_group = n_sms / groups > 1 ? n_sms / groups : 1;
    const dim3 grid(n_tiles < per_group ? n_tiles : per_group, groups);
    topk_count_kernel<<<grid, kCountThreads, smem, stream>>>(
        q, qp, h, s_t, rowids, np, counts, hist, 1u);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2)
    topk_select_kernel<<<qp, kSelThreads, 0, stream>>>(
        counts, hist, h, np, rowids, topc_in, topr_in, k, topc_out, topr_out);
  return cudaGetLastError();
}

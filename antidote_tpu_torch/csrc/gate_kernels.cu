// The causal dependency gate's fixpoint for Hopper (sm_90a).
//
// gate_fixpoint replaces two XLA programs of the JAX package, the same
// cascade in both: antidote_tpu/interdc/gate_kernels.py ring_fixpoint
// (:98, the resident ring, dead slots gated out by `live`) and
// antidote_tpu/interdc/dep.py gate_fixpoint (:968, the repack path,
// every row live; here `live` is null).  JAX runs it as one
// lax.while_loop whose condition never leaves the chip; eager PyTorch
// would read that condition on the host once a round.  This kernel runs
// every round in one launch.
//
// Each round, over the live rows (ss int64[n, d] snapshot VCs, origin
// int32[n] dense origin column, pos int32[n] per-origin FIFO position,
// ts int64[n], ping bool[n]):
//   ready      = live & (ping | pvc >= ss with the own-origin column 0)
//   blocked[o] = min pos over live, not-ready rows of origin o
//                (INT32_MAX where there is none)
//   applied    = ready & pos < blocked[origin]
//   pvc        = max(pvc, 0, ts of applied rows, ts - 1 of blocked
//                heads: live, not ready, pos == blocked[origin]),
//                the maxima taken per origin column
// and the rounds repeat while pvc changes.  rounds[i] is the first
// round that applied row i (-1 if none).  JAX evaluates once more at
// the stable clock; that evaluation equals the last round's (the clock
// did not change), so the last round's `applied` is the result.
//
// Bound: one read of the inputs and one write of the outputs, about
// 8.4 MB at the 256-DC gate (n = 2,048, d = 512): 2.5 us at 3.35 TB/s.
// The rounds are data-dependent and separated by block-wide barriers,
// so this first design is one block of 1,024 threads, far from that
// bound: it keeps pvc, the per-origin blocked minima and the per-origin
// advance maxima in shared memory (20 bytes a column), separates the
// three steps of a round with __syncthreads, and reduces with shared
// atomicMin (int32) and atomicMax (long long).  The dominance test runs
// one warp per row over 32 consecutive columns at a time (coalesced
// 256-byte loads) and stops at the first failing chunk.  Because pvc
// only grows, a chunk that passed once passes in every later round: each
// row keeps the chunk it stopped at (`prog`) and resumes there, so over
// the whole fixpoint every row's snapshot is read about once, and a row
// once ready is never tested again.  The snapshot rows (8 MB at the
// 256-DC gate) stay in L2 between rounds.
//
// A row whose origin lies outside [0, d) is inert (the gate's column map
// never produces one).  The entry point launches on the given stream,
// never synchronises, allocates nothing (`prog` is the caller's int32[n]
// scratch) and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;  // the type CUDA's 64-bit atomicMax takes

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInert = -1;  // prog of a dead row

__global__ void __launch_bounds__(kThreads)
gate_fixpoint_kernel(const i64* __restrict__ ss,
                     const int32_t* __restrict__ origin,
                     const int32_t* __restrict__ pos,
                     const i64* __restrict__ ts,
                     const uint8_t* __restrict__ ping,
                     const uint8_t* __restrict__ live,
                     const i64* __restrict__ pvc_in, int n, int d,
                     uint8_t* __restrict__ applied,
                     int32_t* __restrict__ rounds,
                     i64* __restrict__ pvc_out,
                     uint8_t* __restrict__ new_live,
                     int32_t* __restrict__ count,
                     int32_t* __restrict__ prog) {
  extern __shared__ __align__(16) unsigned char smem[];
  i64* s_pvc = reinterpret_cast<i64*>(smem);
  i64* s_adv = s_pvc + d;
  int32_t* s_blocked = reinterpret_cast<int32_t*>(s_adv + d);
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  // prog[i] == n_chunks: row i is ready; in [0, n_chunks): the first
  // chunk of columns not yet shown dominated; kInert: dead
  const int n_chunks = (d + kWarp - 1) / kWarp;

  for (int c = tid; c < d; c += blockDim.x) s_pvc[c] = pvc_in[c];
  for (int i = tid; i < n; i += blockDim.x) {
    const bool lv = (live == nullptr || live[i]) && origin[i] >= 0 &&
                    origin[i] < d;
    prog[i] = !lv ? kInert : (ping[i] ? n_chunks : 0);
    rounds[i] = -1;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  for (int r = 0;; ++r) {
    for (int c = tid; c < d; c += blockDim.x) {
      s_blocked[c] = INT_MAX;
      s_adv[c] = 0;
    }
    __syncthreads();

    // 1. readiness, one warp a row; live rows that stay not ready bound
    //    their origin's applicable prefix
    for (int i = warp; i < n; i += n_warps) {
      int p = prog[i];
      if (p < 0 || p >= n_chunks) continue;  // the same for the warp
      const int o = origin[i];
      const i64* row = ss + static_cast<size_t>(i) * d;
      for (; p < n_chunks; ++p) {
        const int c = p * kWarp + lane;
        const bool ok = c >= d || s_pvc[c] >= (c == o ? 0 : row[c]);
        if (!__all_sync(kFull, ok)) break;
      }
      if (lane == 0) {
        prog[i] = p;
        if (p < n_chunks) atomicMin(&s_blocked[o], pos[i]);
      }
    }
    __syncthreads();

    // 2. the applicable FIFO prefixes and the per-origin advances
    for (int i = tid; i < n; i += blockDim.x) {
      const int p = prog[i];
      bool app = false;
      if (p >= 0) {
        const int o = origin[i];
        const int32_t bound = s_blocked[o];
        if (p >= n_chunks) {
          app = pos[i] < bound;
          if (app) {
            if (rounds[i] < 0) rounds[i] = r;
            atomicMax(&s_adv[o], ts[i]);
          }
        } else if (pos[i] == bound && ts[i] - 1 > 0) {
          atomicMax(&s_adv[o], ts[i] - 1);  // the blocked head's ts - 1
        }
      }
      applied[i] = app;
    }
    __syncthreads();

    // 3. the clock's advance; another round while it moved
    int moved = 0;
    for (int c = tid; c < d; c += blockDim.x) {
      if (s_adv[c] > s_pvc[c]) {
        s_pvc[c] = s_adv[c];
        moved = 1;
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  int mine = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    mine += applied[i];
    if (new_live != nullptr) new_live[i] = live[i] && !applied[i];
  }
  atomicAdd(&s_count, mine);
  for (int c = tid; c < d; c += blockDim.x) pvc_out[c] = s_pvc[c];
  __syncthreads();
  if (tid == 0) *count = s_count;
}

}  // namespace

extern "C" {

// live and new_live may both be null (every row live: dep.gate_fixpoint);
// otherwise both are given.
int antidote_gate_fixpoint(const void* ss, const void* origin,
                           const void* pos, const void* ts, const void* ping,
                           const void* live, const void* pvc_in, int n, int d,
                           void* applied, void* rounds, void* pvc_out,
                           void* new_live, void* count, void* prog,
                           void* stream) {
  const size_t smem = static_cast<size_t>(d) * (2 * sizeof(i64) +
                                                sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      gate_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gate_fixpoint_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(ss), static_cast<const int32_t*>(origin),
      static_cast<const int32_t*>(pos), static_cast<const i64*>(ts),
      static_cast<const uint8_t*>(ping), static_cast<const uint8_t*>(live),
      static_cast<const i64*>(pvc_in), n, d,
      static_cast<uint8_t*>(applied), static_cast<int32_t*>(rounds),
      static_cast<i64*>(pvc_out), static_cast<uint8_t*>(new_live),
      static_cast<int32_t*>(count), static_cast<int32_t*>(prog));
  return cudaGetLastError();
}

}  // extern "C"

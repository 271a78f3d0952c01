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
// round that applied row i (-1 if none).  Every step is monotone in pvc
// (ready grows, so blocked grows, so applied grows): the last round's
// `applied` is every row ever applied, and it equals the evaluation JAX
// makes once more at the stable clock.
//
// Bound: one read of the inputs and one write of the outputs, about
// 8.4 MB at the 256-DC gate (n = 2,048, d = 512): 2.5 us at 3.35 TB/s.
// No design reaches it: the rounds are data-dependent (8 applying
// rounds and two more on the cascade), and each needs every row's
// verdict before the next, so a round costs at least the barriers that
// separate its steps and, for a row whose dependencies moved, a load's
// round trip.  The design spends as few of both as it can (PERF.md
// records the times of the kernel and of the choices below on an H100).
//
// * One thread-block cluster, not one block.  The wrapper
//   (interdc/gate_kernels.py fixpoint_geometry) picks from n and d
//   alone: one CTA of a warp a row (at most 512 threads) up to 256
//   rows, else a cluster of up to 16 CTAs of 1,024 threads, about 128
//   rows a CTA (cudaLaunchKernelEx, 16 through the non-portable size,
//   checked resident with cudaOccupancyMaxActiveClusters).  Each CTA
//   owns a contiguous range of rows and a contiguous slice of the
//   columns.  On one CTA a barrier is __syncthreads.
// * The per-origin tables.  The blocked minima (int32) are split by
//   column across the cluster's shared memory: a row's atomicMin goes to
//   the owning CTA's slice through distributed shared memory
//   (cluster.map_shared_rank).  The advance maxima (int64) live in a
//   global table of 2 x d words that stays in L2: with the advances in
//   distributed shared memory too, the kernel's 64-bit atomicMax into
//   another CTA's shared memory lost updates on the H100 (the 32-bit
//   minima there were exact), so the cluster sends them to L2, where
//   64-bit atomics are exact, and reads them back past L1.  The clock pvc is replicated: every CTA keeps all d
//   columns in its shared memory, so the dominance test reads only its
//   own.  After a round's advances
//   every CTA reads the whole advance table and updates its own copy;
//   all copies see the same values, so every CTA reaches the same "pvc
//   moved" verdict with no gathering, and all leave the loop at the
//   same round.  One CTA keeps every table in its shared memory.
// * Two cluster barriers a round, not three.  The tables are double-
//   buffered by round parity: round r uses buffer r & 1 and, after its
//   first barrier (every CTA is past round r - 1, the last reader of
//   buffer (r + 1) & 1), the owner resets the other buffer for round
//   r + 1.  The steps are: readiness and blocked minima | barrier |
//   applied prefixes and advances | barrier | the clock (a CTA-wide OR
//   of "moved" ends the round).  A final barrier keeps every CTA's
//   shared memory alive until no other CTA reads it.
// * Witnesses: a row is read about once.  A row's scan reads its
//   snapshot from device memory, two 16-byte loads a lane (128 columns,
//   1 KB a warp) a round trip, and remembers up to four failing
//   columns and the value it needs at each.  While a witness still
//   fails the row is not ready and costs no load; once all pass, a
//   complete scan makes the row ready with no load, and an incomplete
//   one (more failing columns than witnesses) goes on from where it
//   stopped.  Because pvc only grows, a column that passed passes in
//   every later round.  A cascade row has at most two failing columns,
//   so it is read in the first round only.  The snapshots stay in L2
//   between rounds and are not staged in shared memory (a CTA's share
//   is 512 KB); each CTA keeps its rows' state (prog, witnesses,
//   origin, pos, ts) there.
// * Balance: the rows to scan in a round go to a list the CTA's warps
//   share, so a warp whose rows all moved does not hold the round back
//   (with a warp for each row, warp w takes row w and there is no list).
// * No width limit.  Where a CTA's tables (8 d + 8 d / CTAs bytes in a
//   cluster, 32 d on one CTA) do not fit its 227 KB, they live in the
//   global scratch the wrapper allocates (each CTA's clock copy, both
//   parities of both tables; read past L1 with __ldcg), and the same
//   algorithm runs on them; likewise the rows' state.
//
// A row whose origin lies outside [0, d) is inert (the gate's column map
// never produces one).  The entry point launches on the given stream,
// never synchronises, allocates nothing (`rows`, where the rows' state
// is not in shared memory, and `tables` are the caller's scratch), sets a kernel's attributes once per shared-memory
// size and cluster shape, and returns cudaGetLastError().
// antidote_gate_probe runs the same launch shape and barriers with no
// loads, to time a launch and a round's barriers.

#include <climits>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using i64 = long long;  // the type CUDA's 64-bit atomicMax takes

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr int kUnroll = 2;        // chunks a lane loads from a row at once
constexpr int kWitness = 4;       // failing columns a row remembers
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDead = -1;         // prog of a dead row
constexpr int kStray = -2;        // prog of a live row with no origin
constexpr int kHeader = 16;       // dynamic shared bytes before the clock
constexpr int kMaxCtas = 16;
// a row's state: ts and the witnesses' needs (int64); prog, the
// witness count, the witnesses' columns, a slot of the scan list,
// origin and pos (int32)
constexpr int kRowWords = 1 + kWitness;
constexpr int kRowInts = 5 + kWitness;
constexpr int kRowBytes = 8 * kRowWords + 4 * kRowInts;

// A row's scan: its columns before chunk prog were read, and those that
// failed (pvc < ss, own column read as 0) are its witnesses: up to
// kWitness columns, each with the value the row needs there.  A row is
// ready once its scan is complete (prog = n_chunks) and it has no
// witness.  prog: kDead, kStray (both inert); [0, n_chunks] the scan;
// n_chunks + 1 applied.  A CTA keeps its rows' state in shared memory
// from byte rows_at where it fits (rows_at > 0), else in `rows`: n
// rows' int64 state, then their int32 state, of the caller's scratch.
struct Args {
  const i64* ss;
  const int32_t* origin;
  const int32_t* pos;
  const i64* ts;
  const uint8_t* ping;
  const uint8_t* live;
  const i64* pvc_in;
  int n, d;
  uint8_t* applied;
  int32_t* rounds;
  i64* pvc_out;
  uint8_t* new_live;
  int32_t* count;
  i64* rows;
  i64* tables;  // global tables, or null: the tables are in shared memory
  int rows_at;
};

// A CTA's rows' state, row i at [i - row0]; witness w of row i at
// [w * stride + i - row0].
struct Rows {
  int32_t* prog;
  int32_t* nfail;  // witnesses
  int32_t* fail;   // their columns
  i64* need;       // what the row needs there
  int32_t* todo;   // phase 1's list of rows to scan
  const int32_t* origin;
  const int32_t* pos;
  const i64* ts;
  int stride;
};

template <bool kCluster>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// a pointer into CTA `rank`'s shared memory at the same offset as `p`
template <bool kCluster, typename T>
__device__ __forceinline__ T* on_rank(T* p, int rank) {
  if constexpr (kCluster) {
    return cg::this_cluster().map_shared_rank(p, rank);
  } else {
    return p;
  }
}

// A load of what other CTAs wrote: past L1 where it is global memory.
template <bool kInGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kInGlobal) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// The blocked and advance tables, both parities (round r uses r & 1).
// Blocked minima: with kGlobal, all d columns in global scratch; else
// this CTA's slice of cpc columns in shared memory, the owner of column
// c being c / cpc (distributed shared memory in a cluster).  Advance
// maxima: in shared memory on one CTA (cpc = d); in global scratch in a
// cluster (64-bit atomicMax into another CTA's shared memory loses
// updates on the H100) and with kGlobal.
template <bool kCluster, bool kGlobal>
struct Tables {
  static constexpr bool kAdvGlobal = kGlobal || kCluster;
  i64* adv;
  int32_t* blocked;
  int d, cpc;

  __device__ __forceinline__ i64* adv_at(int c, int par) const {
    if constexpr (kAdvGlobal) {
      return adv + static_cast<size_t>(par) * d + c;
    } else {
      return adv + par * cpc + c;
    }
  }
  __device__ __forceinline__ int32_t* blocked_at(int c, int par) const {
    if constexpr (kGlobal) {
      return blocked + static_cast<size_t>(par) * d + c;
    } else {
      const int owner = c / cpc;
      return on_rank<kCluster>(blocked + par * cpc + (c - owner * cpc),
                               owner);
    }
  }
  __device__ __forceinline__ i64 read_adv(int c, int par) const {
    return load<kAdvGlobal>(adv_at(c, par));
  }
  __device__ __forceinline__ int32_t read_blocked(int c, int par) const {
    return load<kGlobal>(blocked_at(c, par));
  }
  // the owner's reset of its columns [c0, c1) for the round of parity par
  __device__ __forceinline__ void reset(int c0, int c1, int par) const {
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      if constexpr (kAdvGlobal) {
        __stcg(adv_at(c, par), 0LL);
      } else {
        *adv_at(c, par) = 0;
      }
      if constexpr (kGlobal) {
        __stcg(blocked_at(c, par), INT_MAX);
      } else {  // own slice: no cluster mapping needed
        blocked[par * cpc + (c - c0)] = INT_MAX;
      }
    }
  }
};

// This lane's V columns of kUnroll chunks of `row` from chunk p on (a
// chunk is 32 * V columns), loaded before any is compared.
template <int V>
__device__ __forceinline__ void load_chunks(const i64* __restrict__ row,
                                            int d, int p, int lane,
                                            i64 (&v)[kUnroll * V]) {
  const int first = p * kWarp * V + lane * V;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int c = first + k * kWarp * V;
    if constexpr (V == 2) {
      longlong2 x = make_longlong2(0, 0);
      if (c < d) x = __ldg(reinterpret_cast<const longlong2*>(row + c));
      v[2 * k] = x.x;
      v[2 * k + 1] = x.y;
    } else {
      v[k] = c < d ? __ldg(row + c) : 0;
    }
  }
}

// Do row j's witnesses all pass?
__device__ __forceinline__ bool witnesses_pass(const Rows& rs, int j,
                                               const i64* pvc) {
  const int m = rs.nfail[j];
  bool pass = true;
  for (int w = 0; w < m; ++w) {
    const int at = w * rs.stride + j;
    pass &= pvc[rs.fail[at]] >= rs.need[at];
  }
  return pass;
}

// One warp scans row j on from chunk prog, kUnroll chunks a round trip,
// collecting its failing columns (pvc < ss, own column read as 0) in
// column order as witnesses, and stops at a failing column past
// kWitness; a row left with a witness bounds its origin's prefix.
template <int V, typename T>
__device__ __forceinline__ void scan(const i64* __restrict__ ss,
                                     const Rows& rs, int j, int row0, int d,
                                     int n_chunks, const i64* pvc, int lane,
                                     const T& t, int par) {
  const int o = rs.origin[j];
  const i64* row = ss + static_cast<size_t>(row0 + j) * d;
  int m = 0, stop = n_chunks;
  for (int p = rs.prog[j]; p < n_chunks && stop == n_chunks; p += kUnroll) {
    i64 v[kUnroll * V];
    load_chunks<V>(row, d, p, lane, v);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int c0 = (p + k) * kWarp * V + lane * V;
      unsigned bad[V];
      i64 want[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = c0 + e;
        want[e] = c == o ? 0 : v[k * V + e];
        bad[e] = __ballot_sync(kFull, c < d && pvc[c] < want[e]);
      }
      // the failing columns in column order: lane by lane, then e
      for (unsigned any = bad[0] | bad[V - 1]; any && stop == n_chunks;) {
        if (m == kWitness) {
          stop = p + k;
          break;
        }
        const int l = __ffs(any) - 1;
        const int e = (bad[0] >> l & 1) ? 0 : V - 1;
        const i64 need = __shfl_sync(kFull, e ? want[V - 1] : want[0], l);
        if (lane == 0) {
          rs.fail[m * rs.stride + j] = (p + k) * kWarp * V + l * V + e;
          rs.need[m * rs.stride + j] = need;
        }
        ++m;
        if (e) {
          bad[V - 1] &= ~(1u << l);
        } else {
          bad[0] &= ~(1u << l);
        }
        any = bad[0] | bad[V - 1];
      }
    }
  }
  if (lane == 0) {
    rs.prog[j] = stop;
    rs.nfail[j] = m;
    if (m > 0) atomicMin(t.blocked_at(o, par), rs.pos[j]);
  }
}

// V: columns a lane loads at once (2 where every row starts on 16
// bytes); kCluster: more than one CTA; kGlobal: the tables in `tables`.
// Any multiple of 32 threads up to kMaxThreads.
template <int V, bool kCluster, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads, 1)
gate_fixpoint_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_count = reinterpret_cast<int*>(smem);  // rank 0's is the total
  int* s_todo = s_count + 1;                    // phase 1's list's length

  const int d = a.d;
  const int ctas = gridDim.x;                   // the grid is one cluster
  const int rank = blockIdx.x;
  const int cpc = max(1, (d + ctas - 1) / ctas);
  const int rpc = (a.n + ctas - 1) / ctas;
  const int row0 = min(a.n, rank * rpc);
  const int row1 = min(a.n, row0 + rpc);
  const int col0 = min(d, rank * cpc);
  const int col1 = min(d, col0 + cpc);
  const int n_chunks = (d + kWarp * V - 1) / (kWarp * V);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  // the rows' state: in shared memory (ts, need; prog, nfail, fail,
  // todo, origin, pos), else in the caller's scratch (need; prog, nfail,
  // fail, todo) and the inputs
  Rows rs;
  int32_t* staged = nullptr;  // the staged origin and pos, or null
  i64* staged_ts = nullptr;
  if (a.rows_at > 0) {
    i64* w = reinterpret_cast<i64*>(smem + a.rows_at);
    int32_t* q = reinterpret_cast<int32_t*>(w + kRowWords * rpc);
    staged = q + (3 + kWitness) * rpc;
    staged_ts = w;
    rs = Rows{q,       q + rpc, q + 2 * rpc, w + rpc, q + (2 + kWitness) * rpc,
              staged,  staged + rpc, w, rpc};
  } else {
    int32_t* q = reinterpret_cast<int32_t*>(a.rows + kWitness * a.n);
    rs = Rows{q + row0, q + a.n + row0, q + 2 * a.n + row0,
              a.rows + row0, q + (2 + kWitness) * a.n + row0,
              a.origin + row0, a.pos + row0, a.ts + row0, a.n};
  }
  i64* pvc;
  Tables<kCluster, kGlobal> t;
  t.d = d;
  t.cpc = cpc;
  if constexpr (kGlobal) {         // every CTA's clock, advances, minima
    pvc = a.tables + static_cast<size_t>(rank) * d;
    t.adv = a.tables + static_cast<size_t>(ctas) * d;
    t.blocked = reinterpret_cast<int32_t*>(t.adv + 2 * static_cast<size_t>(d));
  } else if constexpr (kCluster) {  // shared: clock, minima; global: advances
    pvc = reinterpret_cast<i64*>(smem + kHeader);
    t.blocked = reinterpret_cast<int32_t*>(pvc + d);
    t.adv = a.tables;
  } else {                          // all in shared memory
    pvc = reinterpret_cast<i64*>(smem + kHeader);
    t.adv = pvc + d;
    t.blocked = reinterpret_cast<int32_t*>(t.adv + 2 * cpc);
  }

  // the clock and the rows' state; a thread issues all its loads before
  // it stores (each round trip to device memory is on the critical path)
  for (int x = tid; x < max(d, row1 - row0); x += nt) {
    const int i = row0 + x;
    const bool col = x < d, row = i < row1;
    const i64 c = col ? a.pvc_in[x] : 0;
    const int o = row ? a.origin[i] : 0;
    const int32_t ps = row ? a.pos[i] : 0;
    const i64 ts = row ? a.ts[i] : 0;
    const bool in = row && (a.live == nullptr || a.live[i]);
    const bool pg = row && a.ping[i];
    if (col) pvc[x] = c;
    if (!row) continue;
    rs.prog[x] = !in ? kDead : o < 0 || o >= d ? kStray : pg ? n_chunks : 0;
    rs.nfail[x] = 0;
    if (staged != nullptr) {
      staged[x] = o;
      staged[rpc + x] = ps;
      staged_ts[x] = ts;
    }
    a.rounds[i] = -1;
  }
  t.reset(col0, col1, 0);
  if (tid == 0) *s_count = *s_todo = 0;
  cluster_sync<kCluster>();

  for (int r = 0;; ++r) {
    const int par = r & 1;

    // 1. readiness; live rows that stay not ready bound their origin's
    //    applicable prefix.  A row with a witness that still fails is
    //    not ready and costs no load; one whose witnesses all pass is
    //    ready if its scan is complete, else the scan goes on (`scan`,
    //    a warp a row).  With a warp for each of the CTA's rows, warp w
    //    takes row w; else (a) a thread a row checks the witnesses and
    //    lists the rows to scan, and (b) the warps share the list.
    if (rpc <= nt / kWarp) {
      const int j = warp;
      const int p = row0 + j < row1 ? rs.prog[j] : kDead;
      if (p >= 0 && p <= n_chunks) {
        const bool pass = witnesses_pass(rs, j, pvc);
        __syncwarp();                 // every lane read the witnesses
        if (!pass) {
          if (lane == 0) {
            atomicMin(t.blocked_at(rs.origin[j], par), rs.pos[j]);
          }
        } else {
          if (lane == 0) rs.nfail[j] = 0;
          if (p < n_chunks) {
            scan<V>(a.ss, rs, j, row0, d, n_chunks, pvc, lane, t, par);
          }
        }
      }
    } else {
      for (int base = row0 + warp * kWarp; base < row1; base += nt) {
        const int j = base + lane - row0;
        const int p = j < row1 - row0 ? rs.prog[j] : kDead;
        bool listed = false;
        if (p >= 0 && p <= n_chunks) {
          if (!witnesses_pass(rs, j, pvc)) {
            atomicMin(t.blocked_at(rs.origin[j], par), rs.pos[j]);
          } else {
            rs.nfail[j] = 0;
            listed = p < n_chunks;
          }
        }
        // one shared atomic a warp
        const unsigned want = __ballot_sync(kFull, listed);
        int slot = 0;
        if (lane == 0 && want) slot = atomicAdd(s_todo, __popc(want));
        slot = __shfl_sync(kFull, slot, 0) +
               __popc(want & ((1u << lane) - 1));
        if (listed) rs.todo[slot] = j;
      }
      __syncthreads();
      const int n_todo = *s_todo;
      for (int q = warp; q < n_todo; q += nt / kWarp) {
        scan<V>(a.ss, rs, rs.todo[q], row0, d, n_chunks, pvc, lane, t, par);
      }
    }
    cluster_sync<kCluster>();
    // every CTA is past round r - 1, the last to read the other parity
    t.reset(col0, col1, par ^ 1);
    if (tid == 0) *s_todo = 0;

    // 2. the applicable FIFO prefixes and the per-origin advances (a row
    //    applied earlier already raised its origin's clock past its ts)
    for (int i = row0 + tid; i < row1; i += nt) {
      const int j = i - row0;
      const int p = rs.prog[j];
      const int o = rs.origin[j];
      const int32_t ps = rs.pos[j];
      const i64 ts = rs.ts[j];
      if (p < 0 || p > n_chunks) continue;
      const int32_t bound = t.read_blocked(o, par);
      if (p == n_chunks && rs.nfail[j] == 0) {
        if (ps < bound) {
          rs.prog[j] = n_chunks + 1;
          a.rounds[i] = r;
          atomicMax(t.adv_at(o, par), ts);
        }
      } else if (ps == bound && ts - 1 > 0) {
        atomicMax(t.adv_at(o, par), ts - 1);  // the blocked head's ts - 1
      }
    }
    cluster_sync<kCluster>();

    // 3. the clock's advance, the same in every CTA's copy; another
    //    round while it moved
    int moved = 0;
    for (int c = tid; c < d; c += nt) {
      const i64 v = t.read_adv(c, par);
      if (v > pvc[c]) {
        pvc[c] = v;
        moved = 1;
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  int mine = 0;
  for (int i = row0 + tid; i < row1; i += nt) {
    const int p = rs.prog[i - row0];
    const bool app = p > n_chunks;
    mine += app;
    a.applied[i] = app;
    if (a.new_live != nullptr) a.new_live[i] = p != kDead && !app;
  }
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0 && mine) atomicAdd(on_rank<kCluster>(s_count, 0), mine);
  for (int c = col0 + tid; c < col1; c += nt) a.pvc_out[c] = pvc[c];
  // no CTA leaves while another may still read its shared memory
  cluster_sync<kCluster>();
  if (rank == 0 && tid == 0) *a.count = *s_count;
}

// the fixpoint's launch shape and barriers (2 cluster barriers and a
// CTA-wide OR a round, one before and one after the rounds), no loads
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
gate_probe_kernel(int rounds, int32_t* sink) {
  cluster_sync<kCluster>();
  int moved = 0;
  for (int r = 0; r < rounds; ++r) {
    cluster_sync<kCluster>();
    cluster_sync<kCluster>();
    moved += __syncthreads_or(r + 1 < rounds);
  }
  cluster_sync<kCluster>();
  if (sink != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *sink = moved;
}

using FixpointFn = void (*)(const Args);
using ProbeFn = void (*)(int, int32_t*);

FixpointFn fixpoint_fn(int v, bool cluster, bool global) {
  static const FixpointFn fns[2][2][2] = {
      {{gate_fixpoint_kernel<1, false, false>,
        gate_fixpoint_kernel<1, false, true>},
       {gate_fixpoint_kernel<1, true, false>,
        gate_fixpoint_kernel<1, true, true>}},
      {{gate_fixpoint_kernel<2, false, false>,
        gate_fixpoint_kernel<2, false, true>},
       {gate_fixpoint_kernel<2, true, false>,
        gate_fixpoint_kernel<2, true, true>}}};
  return fns[v - 1][cluster][global];
}

// Per device and kernel, the dynamic shared memory its attribute allows,
// and the (device, kernel, CTAs, threads, shared bytes) shapes already
// checked.
std::mutex g_mu;
std::map<std::tuple<int, const void*>, int> g_smem_set;
std::map<std::tuple<int, const void*, int, int, int>, bool> g_shapes;

// One launch's configuration; on the first launch of a shape, the
// kernel's attributes and the cluster's residency.
template <typename Fn>
cudaError_t configure(Fn fn, int ctas, int threads, int smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  if (ctas > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = ctas;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(fn);
  const auto shape = std::make_tuple(dev, key, ctas, threads, smem);
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_shapes.count(shape)) return cudaSuccess;
  int& allowed =
      g_smem_set.try_emplace(std::make_tuple(dev, key), -1).first->second;
  if (allowed < 0 && ctas > 1) {
    err = cudaFuncSetAttribute(
        key, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        key, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (ctas > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, key, cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
  }
  g_shapes[shape] = true;
  return cudaSuccess;
}

// the dynamic shared memory a CTA's tables use: the header, then the
// clock, then (one CTA) both parities of the advances, then both
// parities of the CTA's slice of the minima; its rows' state may follow
int tables_smem(int d, int ctas, bool global) {
  if (global) return kHeader;
  const int cpc = d > 0 ? (d + ctas - 1) / ctas : 1;
  const int adv = ctas > 1 ? 0 : 2 * static_cast<int>(sizeof(i64)) * cpc;
  return kHeader + static_cast<int>(sizeof(i64)) * d + adv +
         2 * static_cast<int>(sizeof(int32_t)) * cpc;
}

}  // namespace

extern "C" {

// live and new_live may both be null (every row live: dep.gate_fixpoint);
// otherwise both are given.  tables: int64 scratch of ctas * d + 3 * d
// words with `global` (every table in global memory), else of 2 * d
// words in a cluster (the advances) and unused on one CTA.  threads: a
// multiple of 32 up to 1,024.  smem must be what the tables use for
// (d, ctas, global), plus 76 bytes a row of a CTA where its rows' state
// is kept in shared memory; rows: int64 scratch of 8 n words where it is
// not, else unused (may be null).  The wrapper computes both alike
// (interdc/gate_kernels.py fixpoint_geometry).
int antidote_gate_fixpoint(const void* ss, const void* origin,
                           const void* pos, const void* ts, const void* ping,
                           const void* live, const void* pvc_in, int n, int d,
                           void* applied, void* rounds, void* pvc_out,
                           void* new_live, void* count, void* rows,
                           void* tables, int ctas, int threads, int global,
                           int smem, void* stream) {
  if (ctas < 1 || ctas > kMaxCtas || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp || n < 0 || d < 0 ||
      smem < 0)
    return cudaErrorInvalidValue;
  const int tables_at = tables_smem(d, ctas, global != 0);
  const int rpc = (n + ctas - 1) / ctas;
  const int rows_at =
      n > 0 && smem == tables_at + kRowBytes * rpc ? tables_at : 0;
  if ((smem != tables_at && rows_at == 0) ||
      (rows_at == 0 && n > 0 && rows == nullptr))
    return cudaErrorInvalidValue;
  const int v =
      (d % 2 == 0 && reinterpret_cast<uintptr_t>(ss) % 16 == 0) ? 2 : 1;
  const FixpointFn fn = fixpoint_fn(v, ctas > 1, global != 0);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(fn, ctas, threads, smem, static_cast<cudaStream_t>(stream),
                &cfg, &attr);
  if (err != cudaSuccess) return err;
  Args a{static_cast<const i64*>(ss),
         static_cast<const int32_t*>(origin),
         static_cast<const int32_t*>(pos),
         static_cast<const i64*>(ts),
         static_cast<const uint8_t*>(ping),
         static_cast<const uint8_t*>(live),
         static_cast<const i64*>(pvc_in),
         n,
         d,
         static_cast<uint8_t*>(applied),
         static_cast<int32_t*>(rounds),
         static_cast<i64*>(pvc_out),
         static_cast<uint8_t*>(new_live),
         static_cast<int32_t*>(count),
         static_cast<i64*>(rows),
         static_cast<i64*>(tables),
         rows_at};
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The barrier probe: `rounds` rounds of the fixpoint's barriers at its
// launch shape (ctas CTAs of `threads`, smem bytes of dynamic shared
// memory).
int antidote_gate_probe(int ctas, int threads, int smem, int rounds,
                        void* stream) {
  if (ctas < 1 || ctas > kMaxCtas || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp || smem < 0 || rounds < 0)
    return cudaErrorInvalidValue;
  const ProbeFn fn =
      ctas > 1 ? gate_probe_kernel<true> : gate_probe_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(fn, ctas, threads, smem, static_cast<cudaStream_t>(stream),
                &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fn, rounds, static_cast<int32_t*>(nullptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"

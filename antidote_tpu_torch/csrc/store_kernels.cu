// The store's append epilogue for Hopper (sm_90a).
//
// ring_append places a batch of B packed rows in the op ring of any
// shard type (mat/store.py _scatter_rows): each op takes its key's
// (lane_off + 1)-th free lane, its row is written there and the lane is
// marked live.  Over the store's layout
//   ops   T[K*L, F]   one row per ring lane, T int32 or int64
//   valid bool[K*L]   lane occupancy
// and the batch key_idx int[B], lane_off int[B] (int32 or int64 each),
// rows T[B, F] (any row stride), active bool[B] (optional), it writes
// overflow bool[B] and updates ops and valid in place.
//
// It replaces no Pallas kernel.  The JAX package's append is XLA's
// gather and scatter (antidote_tpu/mat/store.py:82 _free_lanes, :95
// _scatter_rows); eager PyTorch ran it as ~25 launches, the largest a
// cumsum over the gathered [B, L] free-lane mask in int64.  The plain
// version stays in mat/store.py (_free_lanes, _scatter_rows_plain): it
// is the CPU path and what the card tests hold this kernel to, bit for
// bit.
//
// Semantics, as the plain version defines them: a key outside [0, K) is
// never stored and reads the lanes of key 0 or K-1 (clamped) for its
// overflow; lane_off < 0 or >= the key's free count overflows; a
// masked-off op (active false) is neither stored nor reported.  A
// dropped op writes nothing.
//
// Bound: bytes.  An op reads its key and offset (8-16 B), its key's L
// lane bytes (one 32-byte sector), its row (F * sizeof(T): 88 B at the
// superstep's int32 F = 22) and writes the row, a lane byte and its
// overflow byte: about 220-300 B an op with the sectors the scattered
// writes touch, ~15-20 MB a 65,536-op batch, 5-6 us at 3.35 TB/s.  There
// is no arithmetic to speak of: a thread walks its key's L bytes, 8 at
// a time where the lanes are 8-byte aligned (one load at L = 8), and
// takes the wanted free lane by popcount and bit clearing.
//
// The hazard: every op must rank against the bitmap as it was before
// the batch.  Ops of one key in one batch fill each other's lanes, so a
// thread that saw a sibling's lane already set would miscount, and which
// op overflows would depend on timing.  So the epilogue is two launches
// on one stream: ring_append_lanes reads the bitmap only and writes each
// op's target row (or -1 where the op is dropped) to a [B] scratch;
// ring_append_rows then copies the kept rows, one 32-bit word a thread
// (coalesced reads of the batch, each row's words contiguous in the
// ring), and sets their lanes.  Stream order is the barrier between
// them.  Two kept ops never share a target: ops of one key carry
// distinct offsets, so distinct ranks.
//
// The entry point returns cudaGetLastError() after each launch.  It
// launches on the given stream, never synchronises and allocates
// nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kLow7 = 0x7f7f7f7f7f7f7f7full;
constexpr uint64_t kHigh = 0x8080808080808080ull;

__device__ __forceinline__ int64_t load_index(const void* p, int is64,
                                              int64_t i) {
  return is64 ? static_cast<const int64_t*>(p)[i]
              : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
}

__global__ void __launch_bounds__(kThreads)
ring_append_lanes(const uint8_t* valid, const void* key_idx, int key64,
                  const void* lane_off, int off64, const uint8_t* active,
                  uint8_t* overflow, int64_t* target, int64_t B, int64_t K,
                  int L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= B) return;
  const int64_t key = load_index(key_idx, key64, i);
  int64_t need = load_index(lane_off, off64, i);
  const int64_t kc = key < 0 ? 0 : (key >= K ? K - 1 : key);
  const uint8_t* lanes = valid + kc * L;
  int lane = L;  // L: no such free lane
  if (need >= 0) {
    int l = 0;
    if ((reinterpret_cast<uintptr_t>(lanes) & 7) == 0) {
      for (; l + 8 <= L && lane == L; l += 8) {
        const uint64_t w = *reinterpret_cast<const uint64_t*>(lanes + l);
        // bit 7 of each byte set where that lane is free (byte == 0)
        uint64_t vacant = ~(((w & kLow7) + kLow7) | w) & kHigh;
        const int n = __popcll(vacant);
        if (need < n) {
          for (int j = 0; j < static_cast<int>(need); ++j)
            vacant &= vacant - 1;  // clear the `need` lowest
          lane = l + (__ffsll(static_cast<long long>(vacant)) - 1) / 8;
        } else {
          need -= n;
        }
      }
    }
    for (; l < L && lane == L; ++l) {
      if (lanes[l] != 0) continue;
      if (need == 0) lane = l;
      --need;
    }
  }
  bool ovf = lane >= L;
  bool keep = !ovf && key >= 0 && key < K;
  if (active != nullptr) {
    const bool a = active[i] != 0;
    ovf = ovf && a;
    keep = keep && a;
  }
  overflow[i] = ovf;
  target[i] = keep ? kc * L + lane : -1;
}

// rows and ops as 32-bit words: W words a row (F * sizeof(T) / 4), the
// batch's rows `stride` words apart
__global__ void __launch_bounds__(kThreads)
ring_append_rows(const uint32_t* rows, int64_t stride, const int64_t* target,
                 uint32_t* ops, uint8_t* valid, int64_t B, int W) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= B * W) return;
  const int64_t i = t / W;
  const int c = static_cast<int>(t - i * W);
  const int64_t tgt = target[i];
  if (tgt < 0) return;
  ops[tgt * W + c] = rows[i * stride + c];
  if (c == 0) valid[tgt] = 1;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// ops (W words a row) and valid updated in place; overflow bool[B] and
// target int64[B] (scratch) written; active may be null
int antidote_ring_append(void* ops, void* valid, const void* rows,
                         int64_t stride, const void* key_idx, int key64,
                         const void* lane_off, int off64,
                         const void* active, void* overflow, void* target,
                         int64_t B, int64_t K, int L, int W, void* stream) {
  if (B <= 0 || K <= 0 || L < 1 || W < 1 || stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ring_append_lanes<<<blocks_for(B), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), key_idx, key64, lane_off, off64,
      static_cast<const uint8_t*>(active), static_cast<uint8_t*>(overflow),
      static_cast<int64_t*>(target), B, K, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_append_rows<<<blocks_for(B * W), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(rows), stride,
      static_cast<const int64_t*>(target), static_cast<uint32_t*>(ops),
      static_cast<uint8_t*>(valid), B, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

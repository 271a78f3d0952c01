// The RGA store's append for Hopper (sm_90a).
//
// rga_append_rows writes one packed op block into a document's window
// and delete lanes (mat/rga_store.py rga_append_packed).  The block is
//   packed int64[bp + cp, 7 + D]   rows [0, bp) insert lanes, rows
//                                  [bp, bp + cp) delete lanes, columns
//                                  [lam, act, rlam, ract, elem, dc, ct,
//                                   ss(D)]; delete rows leave rlam, ract
//                                  and elem unused
// and the destinations are the state's 13 columns, int32 or int64 each:
//   window  wlam, wact, wrlam, wract, welem, wdc, wct [NW], wss [NW, D]
//   deletes dlam, dact, ddc, dct [MD], dss [MD, D]
// with the counters wn, dn (int32, 0-d) of lanes in use.
//
// It replaces no Pallas kernel.  The JAX package's append is XLA's
// dynamic_update_slice, one a column (antidote_tpu/mat/rga_store.py
// rga_append); eager PyTorch ran it as ~100 launches a block (an
// arange, a where, a gather and an index-put a column, mat/rga_store.py
// _put_at).  That plain version stays in mat/rga_store.py (rga_append):
// it is the CPU path and what the card tests hold this kernel to, bit
// for bit.
//
// Semantics, as the plain version defines them: the block goes in only
// where the whole padded block fits, ok = (wn + bp <= NW) & (dn + cp <=
// MD); then insert row r lands on window row wn + r and delete row r on
// delete row dn + r, padding rows too (they lie beyond the new counters,
// where every read and fold masks them), each value cast to its column's
// type as Tensor.to casts it (int64 to int32 keeps the low 32 bits).  A
// refused block writes nothing.  The kernel writes ok and the new
// counters, wn + n_ins and dn + n_del where ok (else the old ones), to
// fresh 0-d outputs, as the plain version returns fresh counters.
//
// Bound: launch latency, not bytes.  A block of the RGA cell (bp 1,024,
// cp 512, D 3) reads 123 KB and writes 80 KB: 0.06 us at 3.35 TB/s,
// against a launch's few microseconds.  So the design is one
// launch: one thread a (row, column) word of the packed block, coalesced
// over it, every thread computing ok from the old counters.  The counters
// go to fresh outputs, so no thread can see them advanced and no second
// launch or ticket is needed; thread 0 writes them.
//
// The entry point returns cudaGetLastError() after its launch.  It
// launches on the given stream, never synchronises and allocates
// nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 13;
// packed columns
constexpr int kLam = 0, kAct = 1, kDc = 5, kCt = 6, kNScal = 7;
// destination slots: the window's 8, then the deletes' 5
constexpr int kWss = 7, kDlam = 8, kDact = 9, kDdc = 10, kDct = 11,
              kDss = 12;

struct Columns {
  void* p[kCols];
};

__device__ __forceinline__ void put(const Columns& dst, unsigned is64,
                                    int slot, int64_t i, int64_t v) {
  if ((is64 >> slot) & 1u)
    static_cast<int64_t*>(dst.p[slot])[i] = v;
  else
    static_cast<int32_t*>(dst.p[slot])[i] = static_cast<int32_t>(v);
}

__global__ void __launch_bounds__(kThreads)
rga_append_rows(const int64_t* packed, Columns dst, unsigned is64,
                const int32_t* wn, const int32_t* dn, int64_t nw,
                int64_t md, int64_t bp, int64_t cp, int D, int64_t n_ins,
                int64_t n_del, uint8_t* ok_out, int32_t* wn_out,
                int32_t* dn_out) {
  const int64_t w0 = *wn;
  const int64_t d0 = *dn;
  const bool ok = w0 + bp <= nw && d0 + cp <= md;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t == 0) {
    *ok_out = ok;
    *wn_out = static_cast<int32_t>(ok ? w0 + n_ins : w0);
    *dn_out = static_cast<int32_t>(ok ? d0 + n_del : d0);
  }
  const int W = kNScal + D;
  if (!ok || t >= (bp + cp) * W) return;
  const int64_t r = t / W;
  const int c = static_cast<int>(t - r * W);
  const int64_t v = packed[t];
  if (r < bp) {
    const int64_t row = w0 + r;
    if (c < kNScal)
      put(dst, is64, c, row, v);
    else
      put(dst, is64, kWss, row * D + (c - kNScal), v);
    return;
  }
  const int64_t row = d0 + (r - bp);
  switch (c) {
    case kLam: put(dst, is64, kDlam, row, v); break;
    case kAct: put(dst, is64, kDact, row, v); break;
    case kDc: put(dst, is64, kDdc, row, v); break;
    case kCt: put(dst, is64, kDct, row, v); break;
    default:
      if (c >= kNScal) put(dst, is64, kDss, row * D + (c - kNScal), v);
  }
}

}  // namespace

extern "C" {

// cols: a host array of the 13 destination pointers in the order above;
// is64: bit i set where destination i is int64; ok (1 byte), wn_out and
// dn_out (int32) are written on the device
int antidote_rga_append(const void* packed, void* const* cols, int is64,
                        const void* wn, const void* dn, int64_t nw,
                        int64_t md, int64_t bp, int64_t cp, int D,
                        int64_t n_ins, int64_t n_del, void* ok, void* wn_out,
                        void* dn_out, void* stream) {
  if (bp < 0 || cp < 0 || D < 1 || nw < 0 || md < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns dst;
  for (int i = 0; i < kCols; ++i) dst.p[i] = cols[i];
  const int64_t n = (bp + cp) * (kNScal + D);
  const unsigned blocks =
      n > 0 ? static_cast<unsigned>((n + kThreads - 1) / kThreads) : 1u;
  rga_append_rows<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(packed), dst, static_cast<unsigned>(is64),
      static_cast<const int32_t*>(wn), static_cast<const int32_t*>(dn), nw,
      md, bp, cp, D, n_ins, n_del, static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(wn_out), static_cast<int32_t*>(dn_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

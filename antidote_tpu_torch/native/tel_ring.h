// Native-plane flight recorder ring (ISSUE 16) — the telemetry face of
// the GIL-free fabric.  PR 11 moved the hottest serving paths into C++,
// which made them invisible to the PR-6 observability plane; this ring
// is how they report back WITHOUT re-introducing the GIL/lock costs the
// move removed (Dapper's always-on low-overhead discipline, PAPERS.md).
//
// Shape: a fixed array of 32-byte events plus one monotonically
// increasing head.  The producer is wait-free — it writes the slot at
// ``head & (cap-1)`` and release-stores head+1; when the consumer lags
// the producer simply overwrites (never blocks, never allocates).  The
// consumer (Python's 50 ms drain) reads head, bulk-copies, re-reads
// head, and discards the prefix a concurrent overwrite may have torn —
// every lost event is COUNTED into ``dropped``, so backpressure is a
// statistic, not a stall.
//
// Producer discipline: each ring has at most one producer at a time.
// nodelink's ring is written only by the endpoint's event thread;
// fabric's ring is written by whichever thread holds the hub mutex at
// an existing lock site — in both cases emission adds ZERO mutex
// crossings and ZERO GIL acquisitions to the hot answer/publish paths
// (the [gil-policy] contract).
//
// The event layout and drain semantics are mirrored bit-for-bit by the
// pure-Python ``_PyRing`` twin in antidote_tpu/obs/nativeobs.py (the
// ``_PyLog`` pattern): tests assert byte-identical streams.

#ifndef ANTIDOTE_TPU_NATIVE_TEL_RING_H_
#define ANTIDOTE_TPU_NATIVE_TEL_RING_H_

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

namespace tel {

// Event kinds — mirrored by EVENT_KINDS in antidote_tpu/obs/nativeobs.py;
// the static-suite native-telemetry pass pins the two tables together.
enum : uint16_t {
    TEL_EV_ANSWER = 1,       // nodelink: RPC answered natively (no GIL)
    TEL_EV_PUB_STAGE = 2,    // fabric: frame framed + staged for fan-out
    TEL_EV_SUB_ENQUEUE = 3,  // fabric: frame queued on one subscriber
    TEL_EV_SUB_DRAIN = 4,    // fabric: frame fully written to a socket
    TEL_EV_DROP = 5,         // fabric: overflowing subscriber dropped
};

// One fixed-width slot.  32 bytes so a 4096-slot ring is two pages of
// cache-friendly sequential writes; Python decodes with struct format
// "<QIIHHIQ" (little-endian, matching every target we compile for).
struct TelEvent {
    uint64_t t_ns;    // wall-clock ns (CLOCK_REALTIME — comparable to
                      // Python time.time_ns(), so spans line up)
    uint32_t dur_ns;  // stage duration, saturated at ~4.29 s
    uint32_t bytes;   // payload / frame size
    uint16_t ev;      // TEL_EV_*
    uint16_t aux16;   // ANSWER: rpc-kind id; PUB_STAGE: queued count;
                      // SUB_*: fd low 16; DROP: low-16 frame hash
    uint32_t seq;     // fabric: publish sequence; nodelink: pub_gen
    uint64_t pad;     // reserved — keeps the slot 32 B / power of two
};
static_assert(sizeof(TelEvent) == 32, "TelEvent must stay 32 bytes");

inline uint64_t wall_ns() {
    timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

inline uint32_t sat_u32(uint64_t v) {
    return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
}

struct TelRing {
    static constexpr uint64_t kCap = 4096;  // power of two (index mask)
    TelEvent slots[kCap];
    //: next event number; monotonic, never wraps (the slot index is
    //: ``head & (kCap-1)``) — the consumer's cursor lives in Python
    std::atomic<uint64_t> head{0};
    std::atomic<int> enabled{1};
    //: event-thread liveness: count bumps once per loop iteration and
    //: wall_ns records when — a wedged thread freezes both, which is
    //: exactly what the stall watchdog alarms on
    std::atomic<uint64_t> hb_count{0};
    std::atomic<uint64_t> hb_wall_ns{0};

    // Producer side — wait-free: one relaxed load, one slot write, one
    // release store.  Overwrite-on-full by construction.
    void emit(uint16_t ev, uint16_t aux16, uint32_t dur_ns,
              uint32_t bytes, uint32_t seq) {
        if (!enabled.load(std::memory_order_relaxed)) return;
        uint64_t h = head.load(std::memory_order_relaxed);
        TelEvent& e = slots[h & (kCap - 1)];
        e.t_ns = wall_ns();
        e.dur_ns = dur_ns;
        e.bytes = bytes;
        e.ev = ev;
        e.aux16 = aux16;
        e.seq = seq;
        e.pad = 0;
        head.store(h + 1, std::memory_order_release);
    }

    void beat() {
        hb_count.fetch_add(1, std::memory_order_relaxed);
        hb_wall_ns.store(wall_ns(), std::memory_order_relaxed);
    }

    // Consumer side.  Copies up to max_events events starting at the
    // caller's cursor ``tail`` into buf, advancing *new_tail past
    // every event CONSIDERED (copied or lost).  *dropped counts events
    // the producer overwrote before/during the copy: the lag beyond
    // kCap plus the torn prefix.  Torn rule: a producer writing event
    // e overwrites slot e&(kCap-1) BEFORE publishing head=e+1, so any
    // copied index <= head2 - kCap may be mid-overwrite — the prefix
    // up to and including that index is discarded, never returned.
    long drain(uint64_t tail, uint8_t* buf, long max_events,
               uint64_t* new_tail, uint64_t* dropped) {
        *dropped = 0;
        uint64_t h1 = head.load(std::memory_order_acquire);
        if (tail > h1) tail = h1;        // bogus cursor: clamp forward
        if (h1 - tail > kCap) {          // lagged past the ring: skip
            *dropped += h1 - tail - kCap;
            tail = h1 - kCap;
        }
        uint64_t avail = h1 - tail;
        uint64_t n = max_events < 0 ? 0
                     : (avail < (uint64_t)max_events
                            ? avail : (uint64_t)max_events);
        for (uint64_t i = 0; i < n; i++)
            memcpy(buf + i * sizeof(TelEvent),
                   &slots[(tail + i) & (kCap - 1)], sizeof(TelEvent));
        uint64_t h2 = head.load(std::memory_order_acquire);
        uint64_t torn = 0;
        // indices <= h2 - kCap may be torn (see the rule above)
        if (h2 >= kCap && h2 - kCap + 1 > tail) {
            torn = h2 - kCap + 1 - tail;
            if (torn > n) torn = n;
            if (torn > 0 && torn < n)
                memmove(buf, buf + torn * sizeof(TelEvent),
                        (size_t)(n - torn) * sizeof(TelEvent));
            *dropped += torn;
        }
        *new_tail = tail + n;
        return (long)(n - torn);
    }
};

}  // namespace tel

#endif  // ANTIDOTE_TPU_NATIVE_TEL_RING_H_

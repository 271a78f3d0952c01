// Native node-fabric endpoint — the intra-DC RPC transport's IO plane.
//
// The reference's intra-DC transport is distributed Erlang: every vnode
// command is a gen_server call serviced by BEAM schedulers that
// multiplex thousands of processes without a global lock (reference
// src/clocksi_vnode.erl:99-209 call sites, include/antidote.hrl:28 —
// 20 read servers per vnode).  A pure-Python socket loop cannot match
// that: a peer's accept/serve thread waits for the busy interpreter's
// GIL timeslice just to READ a frame, putting a scheduler-latency floor
// of ~1-4 ms under every RPC (measured, round 3).  This endpoint moves
// everything except the handler itself off the GIL:
//
// - one C++ event thread per endpoint owns every socket (listener,
//   accepted, outbound) and does all framing, reads, and writes;
// - Python worker threads block INSIDE `nl_recv` (ctypes drops the GIL
//   for the duration of the call), so a request is parsed and queued
//   with zero interpreter involvement and the worker wakes holding a
//   complete message;
// - the client side is PIPELINED: `nl_send` enqueues a frame tagged
//   with a correlation id and returns immediately; any number of
//   requests ride one connection concurrently and `nl_wait` blocks
//   (GIL-free) on just its own id — a coordinator fans 2PC prepares
//   out to N peers in one thread with no thread spawns
//   (the reference's async broadcast-and-collect,
//   src/clocksi_interactive_coord.erl:514-577).
//
// Wire format (both directions): [4B length BE][8B corr id BE][payload]
// where length counts the payload only.  Payloads are the same
// termcodec frames the Python NodeLink speaks; the at-most-once
// request cache and all protocol semantics stay in Python
// (antidote_tpu/cluster/link.py) — this file is transport only, with
// ONE protocol-aware addition (ISSUE 12):
//
// - the PUBLISHED-ANSWER table: Python publishes (request key ->
//   encoded reply) pairs for registered read-only RPCs, and the event
//   thread answers a matching inbound request directly — the reply is
//   queued without the interpreter ever waking, so a busy peer's GIL
//   (the 1-4 ms scheduler-latency floor) stops taxing hot reads
//   (SNAPSHOT_READ at a covered clock, gap-repair ranges off the PR-8
//   index, handoff byte-reads).  The key is the request frame with the
//   per-request rid element spliced out: termcodec encodes the 4-tuple
//   (origin, rid, kind, payload) as concatenated element terms, and
//   the rid (ints, never memoized) cannot shift the string/VC memo
//   state, so origin+kind+payload bytes are a stable identity — the
//   origin MUST stay in the key because later memo back-references can
//   point into strings it registered.  A miss (nothing published,
//   frontier moved, unparseable frame) falls through to the Python
//   worker path unchanged — the universal fallback.  Published answers
//   are deterministic reply bytes, so a retry of an rid answered
//   natively reads the same bytes the at-most-once cache would have
//   remembered: exactly-once semantics are preserved without it.
//
// C ABI for ctypes (no pybind11 in this environment).

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

#include "tel_ring.h"

namespace {

constexpr size_t kMaxFrame = 256u << 20;  // payload cap, either direction
constexpr size_t kHdr = 12;               // 4B len + 8B corr

uint32_t rd_u32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

uint64_t rd_u64(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

void wr_u32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8); p[3] = (uint8_t)v;
}

void wr_u64(uint8_t* p, uint64_t v) {
    for (int i = 7; i >= 0; i--) { p[i] = (uint8_t)v; v >>= 8; }
}

using Bytes = std::shared_ptr<std::vector<uint8_t>>;

struct OutFrame {
    Bytes data;
    size_t sent = 0;
    uint64_t corr = 0;  // 0 for server replies (nothing to fail)
};

struct Conn {
    int fd = -1;
    bool outbound = false;
    int peer = -1;        // outbound: peer index
    uint64_t token = 0;   // inbound: identifies the conn for replies
    bool connecting = false;
    //: marked by any thread (under mu); read lock-free by the event
    //: thread mid-iteration, hence atomic; reaped at the next loop top
    std::atomic<bool> dead{false};
    // incremental read state — EVENT THREAD ONLY, never locked
    uint8_t hdr[kHdr];
    size_t hdr_got = 0;
    Bytes body;
    size_t body_got = 0;
    uint64_t corr = 0;
    // write queue: senders push_back under mu; only the event thread
    // pops, so the front is stable across its unlocked send() calls
    std::deque<OutFrame> wq;
    //: corr ids ever queued on this conn, swept to FAIL on conn death;
    //: compacted lazily against the pending map
    std::vector<uint64_t> sent_corrs;
};

//: a frame fully parsed by the event thread, delivered under one brief
//: lock per readiness sweep (the lock must NEVER be held across the
//: read()/send() syscalls themselves — senders convoy behind it)
struct Parsed {
    Conn* conn;
    uint64_t corr;
    Bytes body;
};

struct InMsg {
    uint64_t token;
    uint64_t corr;
    Bytes payload;
    //: byte span of the rid element within payload (0,0 = the frame
    //: did not parse as a 4-tuple request — never publishable)
    uint32_t rid_start = 0;
    uint32_t rid_end = 0;
};

enum PendSt { P_WAIT = 0, P_DONE = 1, P_FAIL = 2 };

struct Pending {
    PendSt st = P_WAIT;
    Bytes data;
};

struct Peer {
    std::string host;
    int port = 0;
    Conn* conn = nullptr;  // owned by Ep::conns
    bool want_dial = false;
    std::deque<OutFrame> predial;  // frames queued before the dial
};

//: a published answer plus the rpc-kind id Python interned for it —
//: the TEL_EV_ANSWER event reports the kind, turning the flat
//: native_answered count into a per-kind latency family (ISSUE 16)
struct PubAns {
    Bytes data;
    uint16_t kind = 0;
};

struct Ep {
    int listen_fd = -1;
    uint16_t port = 0;
    int wake_r = -1, wake_w = -1;
    std::thread thread;
    std::mutex mu;
    std::condition_variable cv_in;    // inbound request queue
    std::condition_variable cv_done;  // pending completions
    std::deque<InMsg> inq;
    std::unordered_map<uint64_t, Pending> pend;
    std::map<int, Peer> peers;
    std::vector<std::unique_ptr<Conn>> conns;
    uint64_t next_token = 1;
    uint64_t next_corr = 1;
    bool stop = false;
    //: the published-answer table (ISSUE 12): request key -> encoded
    //: reply, consulted by the event thread before waking Python.
    //: Bounded FIFO (pub_order) so a hot server cannot grow it
    //: without limit; Python clears it wholesale on any state change
    //: that could invalidate an answer (truncation, ring moves).
    std::unordered_map<std::string, PubAns> published;
    std::deque<std::string> pub_order;
    size_t pub_cap = 4096;
    uint64_t native_answered = 0;
    //: flight-recorder ring (ISSUE 16): written ONLY by the event
    //: thread (deliver_all's native-answer branch, under the mutex it
    //: already holds) — single producer, zero added crossings
    tel::TelRing tel;
    //: invalidation generation: bumped by every wholesale clear, and
    //: nl_publish only installs an answer published AT the current
    //: generation — a worker that computed its reply before a
    //: truncation/ring move cleared the table cannot resurrect the
    //: stale answer afterwards (the check and the insert share the
    //: endpoint mutex, so there is no re-publish window)
    uint64_t pub_gen = 0;
};

void set_nonblock(int fd) {
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
}

void set_nodelay(int fd) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

void wake(Ep* ep) {
    uint8_t b = 1;
    ssize_t r = write(ep->wake_w, &b, 1);
    (void)r;  // pipe full = loop already awake
}

// Fail (under ep->mu) every still-waiting corr queued on this conn.
void fail_corrs(Ep* ep, Conn* c) {
    bool any = false;
    for (uint64_t corr : c->sent_corrs) {
        auto it = ep->pend.find(corr);
        if (it != ep->pend.end() && it->second.st == P_WAIT) {
            it->second.st = P_FAIL;
            any = true;
        }
    }
    c->sent_corrs.clear();
    c->wq.clear();
    if (any) ep->cv_done.notify_all();
}

void fail_predial(Ep* ep, Peer* pr) {
    bool any = false;
    for (auto& f : pr->predial) {
        auto it = ep->pend.find(f.corr);
        if (it != ep->pend.end() && it->second.st == P_WAIT) {
            it->second.st = P_FAIL;
            any = true;
        }
    }
    pr->predial.clear();
    if (any) ep->cv_done.notify_all();
}

// Parse as much buffered input as available, WITHOUT ep->mu (all read
// state is event-thread-only); completed frames go to `out` for batch
// delivery.  Returns false when the conn must be dropped.
bool pump_read(Conn* c, std::vector<Parsed>* out) {
    for (;;) {
        if (c->hdr_got < kHdr) {
            ssize_t r = read(c->fd, c->hdr + c->hdr_got,
                             kHdr - c->hdr_got);
            if (r == 0) return false;
            if (r < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
            c->hdr_got += (size_t)r;
            if (c->hdr_got < kHdr) continue;
            uint32_t len = rd_u32(c->hdr);
            if (len > kMaxFrame) return false;
            c->corr = rd_u64(c->hdr + 4);
            c->body = std::make_shared<std::vector<uint8_t>>(len);
            c->body_got = 0;
        }
        if (c->body_got < c->body->size()) {
            ssize_t r = read(c->fd, c->body->data() + c->body_got,
                             c->body->size() - c->body_got);
            if (r == 0) return false;
            if (r < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
            c->body_got += (size_t)r;
        }
        if (c->body_got == c->body->size()) {
            out->push_back({c, c->corr, std::move(c->body)});
            c->body = nullptr;
            c->hdr_got = 0;
            c->body_got = 0;
        }
    }
}

// Skip one termcodec term starting at `pos`; returns the offset past
// it, or -1 when the term is malformed / an unskippable tag (batch).
// Mirrors antidote_tpu/interdc/termcodec.py's tag table — only the
// SPANS matter here, never the values (memo back-references are fixed
// width), so the skipper stays correct as long as the tag set is.
long term_skip(const uint8_t* d, long len, long pos, int depth) {
    if (depth > 64 || pos >= len) return -1;
    uint8_t tag = d[pos];
    long p = pos + 1;
    uint32_t n = 0;
    switch (tag) {
        case 'N': case 'T': case 'F':
            return p;
        case '1':                       // int8 payload
            return p + 1 <= len ? p + 1 : -1;
        case 'r':                       // str backref, 1 byte
            return p + 1 <= len ? p + 1 : -1;
        case '8': case 'f':             // int64 / double
            return p + 8 <= len ? p + 8 : -1;
        case 'Q': case 'v':             // str / VC backref, u32
            return p + 4 <= len ? p + 4 : -1;
        case 'C': case 'S':             // bytes / str, 1-byte length
            if (p + 1 > len) return -1;
            n = d[p];
            p += 1;
            return p + (long)n <= len ? p + (long)n : -1;
        case 'i': case 'b': case 's':   // length-prefixed payloads
            if (p + 4 > len) return -1;
            n = rd_u32(d + p);
            p += 4;
            return p + (long)n <= len ? p + (long)n : -1;
        case 'u':                       // tuple, 1-byte count
            if (p + 1 > len) return -1;
            n = d[p];
            p += 1;
            break;
        case 't': case 'l': case 'e': case 'z': case 'd':
        case 'V': case 'O': case 'R': case 'X':  // u32-count sequences
            if (p + 4 > len) return -1;
            n = rd_u32(d + p);
            p += 4;
            break;
        default:                        // 'Y' batch / unknown: bail
            return -1;
    }
    if ((long)n > len - p) return -1;   // each item needs >= 1 byte
    for (uint32_t i = 0; i < n; i++) {
        p = term_skip(d, len, p, depth + 1);
        if (p < 0) return -1;
    }
    return p;
}

// Locate the rid element's span inside a request frame — the 4-tuple
// (origin, rid, kind, payload) always encodes as tag 'u', count 4.
// Returns false when the frame is not that shape (a hand-built or
// hostile frame: never answered natively, never published).
bool rid_span(const uint8_t* d, long len, uint32_t* rid_s,
              uint32_t* rid_e) {
    if (len < 2 || d[0] != 'u' || d[1] != 4) return false;
    long e0 = term_skip(d, len, 2, 0);
    if (e0 <= 0) return false;
    long e1 = term_skip(d, len, e0, 0);
    if (e1 <= 0 || e1 > 0xFFFFFFFFL || len > 0xFFFFFFFFL) return false;
    *rid_s = (uint32_t)e0;
    *rid_e = (uint32_t)e1;
    return true;
}

// Queue a reply frame on a server conn (event thread, under ep->mu).
void queue_reply(Conn* c, uint64_t corr, const Bytes& payload) {
    auto frame = std::make_shared<std::vector<uint8_t>>(
        kHdr + payload->size());
    wr_u32(frame->data(), (uint32_t)payload->size());
    wr_u64(frame->data() + 4, corr);
    memcpy(frame->data() + kHdr, payload->data(), payload->size());
    c->wq.push_back({frame, 0, 0});
}

// Deliver a readiness sweep's parsed frames under ONE brief lock.
// Inbound requests consult the published-answer table first: a hit is
// answered right here on the event thread (the reply lands on the
// conn's write queue; the next poll iteration sees POLLOUT) and the
// interpreter never wakes — the GIL-free read-serving path (ISSUE 12).
void deliver_all(Ep* ep, std::vector<Parsed>* parsed) {
    if (parsed->empty()) return;
    bool any_in = false, any_done = false;
    {
        std::lock_guard<std::mutex> g(ep->mu);
        for (auto& p : *parsed) {
            if (p.conn->outbound) {
                auto it = ep->pend.find(p.corr);
                if (it != ep->pend.end() &&
                    it->second.st == P_WAIT) {
                    it->second.st = P_DONE;
                    it->second.data = std::move(p.body);
                    any_done = true;
                }
                // unknown corr: the waiter timed out and cancelled
            } else {
                uint32_t rs = 0, re = 0;
                bool keyed = rid_span(p.body->data(),
                                      (long)p.body->size(), &rs, &re);
                if (keyed && !ep->published.empty()) {
                    uint64_t t0 = tel::wall_ns();
                    std::string key;
                    key.reserve(p.body->size() - (re - rs));
                    key.append((const char*)p.body->data(), rs);
                    key.append((const char*)p.body->data() + re,
                               p.body->size() - re);
                    auto hit = ep->published.find(key);
                    if (hit != ep->published.end()) {
                        queue_reply(p.conn, p.corr, hit->second.data);
                        ep->native_answered++;
                        // dur = key build + lookup + reply queue: the
                        // native answer's whole serve cost (the wire
                        // halves live in the peer's own telemetry)
                        ep->tel.emit(
                            tel::TEL_EV_ANSWER, hit->second.kind,
                            tel::sat_u32(tel::wall_ns() - t0),
                            (uint32_t)hit->second.data->size(),
                            (uint32_t)ep->pub_gen);
                        continue;
                    }
                }
                ep->inq.push_back(
                    {p.conn->token, p.corr, std::move(p.body),
                     keyed ? rs : 0, keyed ? re : 0});
                any_in = true;
            }
        }
    }
    if (any_done) ep->cv_done.notify_all();
    if (any_in) ep->cv_in.notify_all();
    parsed->clear();
}

// Drain the write queue; ep->mu is taken only to peek/advance the
// queue, NEVER across the send() syscall.  Returns false when the conn
// must be dropped.
bool pump_write(Ep* ep, Conn* c) {
    for (;;) {
        Bytes cur;
        size_t off;
        {
            std::lock_guard<std::mutex> g(ep->mu);
            if (c->dead.load(std::memory_order_relaxed)) return true;
            if (c->wq.empty()) return true;
            cur = c->wq.front().data;
            off = c->wq.front().sent;
        }
        bool blocked = false;
        while (off < cur->size()) {
            ssize_t r = send(c->fd, cur->data() + off,
                             cur->size() - off, MSG_NOSIGNAL);
            if (r < 0) {
                if (errno == EAGAIN || errno == EWOULDBLOCK) {
                    blocked = true;
                    break;
                }
                return false;
            }
            off += (size_t)r;
        }
        std::lock_guard<std::mutex> g(ep->mu);
        // a concurrent nl_drop_peer / nl_set_peer may have cleared the
        // queue under us — re-check before touching the front
        if (c->dead.load(std::memory_order_relaxed) || c->wq.empty())
            return true;
        if (blocked) {
            c->wq.front().sent = off;
            return true;
        }
        c->wq.pop_front();
    }
}

// Close + erase a conn (event thread only, under ep->mu).
void reap(Ep* ep, std::vector<std::unique_ptr<Conn>>::iterator it) {
    Conn* c = it->get();
    if (c->outbound) {
        fail_corrs(ep, c);
        auto pit = ep->peers.find(c->peer);
        if (pit != ep->peers.end() && pit->second.conn == c)
            pit->second.conn = nullptr;
    }
    close(c->fd);
    ep->conns.erase(it);
}

void start_dials(Ep* ep) {
    for (auto& kv : ep->peers) {
        Peer& pr = kv.second;
        if (!pr.want_dial || pr.conn != nullptr) continue;
        pr.want_dial = false;
        int fd = socket(AF_INET, SOCK_STREAM, 0);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_port = htons((uint16_t)pr.port);
        if (fd < 0 ||
            inet_pton(AF_INET, pr.host.c_str(), &addr.sin_addr) != 1) {
            if (fd >= 0) close(fd);
            fail_predial(ep, &pr);
            continue;
        }
        set_nonblock(fd);
        set_nodelay(fd);
        int rc = connect(fd, (sockaddr*)&addr, sizeof(addr));
        if (rc < 0 && errno != EINPROGRESS) {
            close(fd);
            fail_predial(ep, &pr);
            continue;
        }
        auto c = std::make_unique<Conn>();
        c->fd = fd;
        c->outbound = true;
        c->peer = kv.first;
        c->connecting = (rc < 0);
        for (auto& f : pr.predial) {
            c->sent_corrs.push_back(f.corr);
            c->wq.push_back(std::move(f));
        }
        pr.predial.clear();
        pr.conn = c.get();
        ep->conns.push_back(std::move(c));
    }
}

void event_loop(Ep* ep) {
    std::vector<pollfd> pfds;
    std::vector<Conn*> snap;
    std::vector<Parsed> parsed;
    for (;;) {
        ep->tel.beat();  // liveness: frozen count+wall = wedged thread
        pfds.clear();
        snap.clear();
        {
            std::lock_guard<std::mutex> g(ep->mu);
            if (ep->stop) break;
            // reap marked-dead conns before snapshotting fds: a revents
            // entry must never hit a conn whose fd was reused
            for (auto it = ep->conns.begin(); it != ep->conns.end();) {
                if ((*it)->dead.load(std::memory_order_relaxed)) {
                    reap(ep, it);
                    it = ep->conns.begin();  // iterator invalidated
                } else {
                    ++it;
                }
            }
            start_dials(ep);
            for (auto& c : ep->conns) {
                short ev = 0;
                if (c->connecting) {
                    ev = POLLOUT;
                } else {
                    ev = POLLIN;
                    if (!c->wq.empty()) ev |= POLLOUT;
                }
                snap.push_back(c.get());
                pfds.push_back({c->fd, ev, 0});
            }
        }
        size_t nsnap = snap.size();
        pfds.push_back({ep->listen_fd, POLLIN, 0});
        pfds.push_back({ep->wake_r, POLLIN, 0});
        if (poll(pfds.data(), pfds.size(), 1000) < 0 && errno != EINTR)
            break;
        if (pfds[nsnap + 1].revents & POLLIN) {
            uint8_t buf[256];
            while (read(ep->wake_r, buf, sizeof(buf)) > 0) {
            }
        }
        if (pfds[nsnap].revents & POLLIN) {
            for (;;) {
                int fd = accept(ep->listen_fd, nullptr, nullptr);
                if (fd < 0) break;
                set_nonblock(fd);
                set_nodelay(fd);
                auto c = std::make_unique<Conn>();
                c->fd = fd;
                std::lock_guard<std::mutex> g(ep->mu);
                c->token = ep->next_token++;
                ep->conns.push_back(std::move(c));
            }
        }
        // conns are created/erased ONLY by this thread, so the snapshot
        // pointers stay valid for the whole sweep; all socket IO below
        // runs WITHOUT ep->mu (holding it across syscalls convoys
        // every nl_send / nl_reply behind the event loop — measured at
        // ~0.9 ms per send under load before this split)
        for (size_t i = 0; i < nsnap; i++) {
            if (!pfds[i].revents) continue;
            Conn* c = snap[i];
            if (c->dead.load(std::memory_order_relaxed)) continue;
            bool ok = true;
            if (c->connecting) {
                if (pfds[i].revents & (POLLOUT | POLLERR | POLLHUP)) {
                    int err = 0;
                    socklen_t elen = sizeof(err);
                    getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err,
                               &elen);
                    if (err != 0) {
                        ok = false;
                    } else {
                        c->connecting = false;
                        ok = pump_write(ep, c);
                    }
                }
            } else {
                if (pfds[i].revents & (POLLERR | POLLNVAL))
                    ok = false;
                if (ok && (pfds[i].revents & POLLIN))
                    ok = pump_read(c, &parsed);
                if (ok && (pfds[i].revents & POLLOUT))
                    ok = pump_write(ep, c);
                // POLLHUP alone with readable data pending is handled
                // by pump_read returning false at EOF
            }
            if (!ok) {
                std::lock_guard<std::mutex> g(ep->mu);
                if (c->outbound) fail_corrs(ep, c);
                c->dead.store(true, std::memory_order_relaxed);
            }
        }
        deliver_all(ep, &parsed);
    }
    // teardown: fail every waiter, close every socket
    std::lock_guard<std::mutex> g(ep->mu);
    for (auto& c : ep->conns) {
        if (c->outbound) fail_corrs(ep, c.get());
        close(c->fd);
    }
    ep->conns.clear();
    for (auto& kv : ep->peers) {
        kv.second.conn = nullptr;
        fail_predial(ep, &kv.second);
    }
    for (auto& kv : ep->pend)
        if (kv.second.st == P_WAIT) kv.second.st = P_FAIL;
    ep->cv_done.notify_all();
    ep->cv_in.notify_all();
}

}  // namespace

extern "C" {

// Returns an opaque handle or 0 on failure.  Binds the listener
// immediately (port 0 = OS-assigned; see nl_port).
void* nl_create(const char* host, int port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
        bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
        listen(fd, 128) < 0) {
        close(fd);
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, (sockaddr*)&addr, &alen);
    set_nonblock(fd);
    auto* ep = new Ep();
    ep->listen_fd = fd;
    ep->port = ntohs(addr.sin_port);
    int pipefd[2];
    if (pipe(pipefd) < 0) {
        close(fd);
        delete ep;
        return nullptr;
    }
    ep->wake_r = pipefd[0];
    ep->wake_w = pipefd[1];
    set_nonblock(ep->wake_r);
    set_nonblock(ep->wake_w);
    ep->tel.beat();  // a watchdog probing before the thread's first
                     // iteration must see "just born", not "wedged"
    ep->thread = std::thread(event_loop, ep);
    return ep;
}

int nl_port(void* hp) { return ((Ep*)hp)->port; }

// Register / update a peer's address.  An existing connection to that
// peer is torn down (in-flight requests fail; the next send re-dials).
void nl_set_peer(void* hp, int peer, const char* host, int port) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    Peer& pr = ep->peers[peer];
    bool changed = pr.host != host || pr.port != port;
    pr.host = host;
    pr.port = port;
    if (changed && pr.conn != nullptr) {
        fail_corrs(ep, pr.conn);
        pr.conn->dead = true;
        pr.conn = nullptr;
        wake(ep);
    }
}

// Queue a request to a peer; returns the correlation id (> 0),
// -1 unknown peer, -2 oversized, -3 endpoint closed.  Never blocks.
long long nl_send(void* hp, int peer, const uint8_t* data, long len) {
    Ep* ep = (Ep*)hp;
    if (len < 0 || (size_t)len > kMaxFrame) return -2;
    // frame built before taking the lock: the memcpy of a large
    // payload must not serialize other senders / the event loop
    auto frame = std::make_shared<std::vector<uint8_t>>(kHdr + len);
    wr_u32(frame->data(), (uint32_t)len);
    memcpy(frame->data() + kHdr, data, (size_t)len);
    {
        std::lock_guard<std::mutex> g(ep->mu);
        if (ep->stop) return -3;
        auto pit = ep->peers.find(peer);
        if (pit == ep->peers.end()) return -1;
        uint64_t corr = ep->next_corr++;
        wr_u64(frame->data() + 4, corr);
        ep->pend[corr] = Pending{};
        Peer& pr = pit->second;
        if (pr.conn != nullptr &&
            !pr.conn->dead.load(std::memory_order_relaxed)) {
            // compact the failure-sweep list once it outgrows the
            // truly-pending set: resolved corrs are gone from `pend`,
            // and a long-lived conn must not accumulate one entry per
            // RPC forever
            if (pr.conn->sent_corrs.size() >= 4096) {
                auto& sc = pr.conn->sent_corrs;
                size_t w = 0;
                for (uint64_t c2 : sc) {
                    auto it = ep->pend.find(c2);
                    if (it != ep->pend.end() &&
                        it->second.st == P_WAIT)
                        sc[w++] = c2;
                }
                sc.resize(w);
            }
            pr.conn->sent_corrs.push_back(corr);
            pr.conn->wq.push_back({frame, 0, corr});
        } else {
            pr.want_dial = true;
            pr.predial.push_back({frame, 0, corr});
        }
        wake(ep);
        return (long long)corr;
    }
}

// Wait for the reply to `corr`.  Returns:
//   > 0  bytes copied into out (entry consumed)
//   0    timeout (entry kept; wait again or nl_cancel)
//   -1   link failed / endpoint closed / unknown corr (entry consumed)
//   < -1 -(needed bytes): out too small, entry kept — retry bigger
long nl_wait(void* hp, unsigned long long corr, uint8_t* out, long cap,
             int timeout_ms) {
    Ep* ep = (Ep*)hp;
    std::unique_lock<std::mutex> lk(ep->mu);
    ep->cv_done.wait_for(
        lk, std::chrono::milliseconds(timeout_ms), [&] {
            if (ep->stop) return true;
            auto it = ep->pend.find(corr);
            return it == ep->pend.end() || it->second.st != P_WAIT;
        });
    auto it = ep->pend.find(corr);
    if (it == ep->pend.end()) return -1;
    if (it->second.st == P_WAIT) {
        if (ep->stop) {
            ep->pend.erase(it);
            return -1;
        }
        return 0;
    }
    if (it->second.st == P_FAIL) {
        ep->pend.erase(it);
        return -1;
    }
    long need = (long)it->second.data->size();
    if (need > cap) return -(need < 2 ? 2 : need);
    memcpy(out, it->second.data->data(), (size_t)need);
    ep->pend.erase(it);
    return need;
}

// Forget a pending request (after a timeout the caller abandons).
void nl_cancel(void* hp, unsigned long long corr) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    ep->pend.erase(corr);
}

// Tear down the connection to a peer (stuck link): in-flight requests
// fail immediately; the next send re-dials fresh.
void nl_drop_peer(void* hp, int peer) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    auto pit = ep->peers.find(peer);
    if (pit == ep->peers.end()) return;
    Peer& pr = pit->second;
    pr.want_dial = false;
    fail_predial(ep, &pr);
    if (pr.conn != nullptr) {
        fail_corrs(ep, pr.conn);
        pr.conn->dead = true;
        pr.conn = nullptr;
        wake(ep);
    }
}

// Receive a BATCH of inbound requests in one call — the GIL-economy
// path: a busy interpreter grants a worker one timeslice; draining the
// whole queue inside it collapses N GIL acquisitions into one (the
// same amortization a BEAM scheduler gets by running a vnode's mailbox
// to empty).  Packs up to max_msgs messages, each
// [8B conn token][8B corr][4B rid start][4B rid end][4B len][payload]
// — the rid span locates the per-request id inside the payload so the
// worker can splice it out when publishing the answer (0,0 = frame did
// not parse as a request tuple; never publishable).  Returns bytes
// written, 0 on timeout, -1 when the endpoint closed, or -(needed)
// when the FIRST message alone exceeds cap (message stays queued).
long nl_recv_batch(void* hp, uint8_t* out, long cap, int timeout_ms,
                   int max_msgs) {
    Ep* ep = (Ep*)hp;
    std::unique_lock<std::mutex> lk(ep->mu);
    ep->cv_in.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
        return ep->stop || !ep->inq.empty();
    });
    if (ep->stop) return -1;
    if (ep->inq.empty()) return 0;
    long written = 0;
    int n = 0;
    while (!ep->inq.empty() && n < max_msgs) {
        InMsg& m = ep->inq.front();
        long need = 28 + (long)m.payload->size();
        if (written + need > cap)
            return written > 0 ? written : -need;
        wr_u64(out + written, m.token);
        wr_u64(out + written + 8, m.corr);
        wr_u32(out + written + 16, m.rid_start);
        wr_u32(out + written + 20, m.rid_end);
        wr_u32(out + written + 24, (uint32_t)m.payload->size());
        memcpy(out + written + 28, m.payload->data(),
               m.payload->size());
        written += need;
        n++;
        ep->inq.pop_front();
    }
    return written;
}

// Publish one (request key -> reply payload) pair for the event
// thread to answer without Python (see the file header).  Replaces an
// existing entry; the table is a bounded FIFO — past the cap the
// oldest published key is evicted (its requests fall back to the
// Python path, which may re-publish).  Never blocks.  `gen` is the
// invalidation generation the publisher read (nl_pub_gen) BEFORE
// computing the answer: a clear that raced the handler bumped it, and
// the stale answer is silently dropped here instead of resurrecting
// into the freshly-cleared table.  `kind` is the rpc-kind id the
// Python side interned for this answer's RPC name (0 = unknown) — the
// TEL_EV_ANSWER event reports it so native answer latency is a
// per-kind family, not a flat count.
void nl_publish(void* hp, const uint8_t* key, long klen,
                const uint8_t* reply, long rlen,
                unsigned long long gen, int kind) {
    Ep* ep = (Ep*)hp;
    if (klen <= 0 || rlen < 0 || (size_t)rlen > kMaxFrame) return;
    auto data = std::make_shared<std::vector<uint8_t>>(reply,
                                                       reply + rlen);
    std::string k((const char*)key, (size_t)klen);
    std::lock_guard<std::mutex> g(ep->mu);
    if (ep->stop || gen != ep->pub_gen) return;
    auto it = ep->published.find(k);
    if (it == ep->published.end()) {
        ep->pub_order.push_back(k);
        ep->published.emplace(
            std::move(k), PubAns{std::move(data), (uint16_t)kind});
        while (ep->published.size() > ep->pub_cap &&
               !ep->pub_order.empty()) {
            ep->published.erase(ep->pub_order.front());
            ep->pub_order.pop_front();
        }
    } else {
        it->second = PubAns{std::move(data), (uint16_t)kind};
    }
}

// Drop every published answer (the wholesale invalidation Python
// calls on truncation / ring moves / ownership changes) and bump the
// generation so in-flight answers computed against the old state
// cannot publish after the clear.
void nl_publish_clear(void* hp) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    ep->published.clear();
    ep->pub_order.clear();
    ep->pub_gen++;
}

// The current invalidation generation — read by the worker BEFORE it
// runs a handler whose answer it may publish (see nl_publish).
unsigned long long nl_pub_gen(void* hp) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    return ep->pub_gen;
}

// Endpoint counters: out[0] = requests answered natively (no GIL),
// out[1] = live published entries, out[2] = inbound queue depth.
// Returns the number of slots filled.
int nl_counters(void* hp, unsigned long long* out, int n) {
    Ep* ep = (Ep*)hp;
    std::lock_guard<std::mutex> g(ep->mu);
    int filled = 0;
    if (n > 0) { out[0] = ep->native_answered; filled = 1; }
    if (n > 1) { out[1] = ep->published.size(); filled = 2; }
    if (n > 2) { out[2] = ep->inq.size(); filled = 3; }
    return filled;
}

// Wait until EVERY listed corr is terminal (or timeout), then pack all
// results in one call — a whole 2PC fan-out round costs the caller a
// single GIL re-acquisition.  Per corr: [1B status][4B len][payload]
// where status 0 = done (entry consumed), 1 = failed (consumed),
// 2 = still pending at timeout (kept: cancel or wait again).
// Returns bytes written, -1 endpoint closed, < -1 -(needed bytes).
long nl_collect(void* hp, const unsigned long long* corrs, int n,
                uint8_t* out, long cap, int timeout_ms) {
    Ep* ep = (Ep*)hp;
    std::unique_lock<std::mutex> lk(ep->mu);
    auto all_done = [&] {
        if (ep->stop) return true;
        for (int i = 0; i < n; i++) {
            auto it = ep->pend.find(corrs[i]);
            if (it != ep->pend.end() && it->second.st == P_WAIT)
                return false;
        }
        return true;
    };
    ep->cv_done.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                         all_done);
    if (ep->stop && n == 0) return -1;
    long need = 0;
    for (int i = 0; i < n; i++) {
        auto it = ep->pend.find(corrs[i]);
        need += 5;
        if (it != ep->pend.end() && it->second.st == P_DONE)
            need += (long)it->second.data->size();
    }
    if (need > cap) return -(need < 2 ? 2 : need);
    long pos = 0;
    for (int i = 0; i < n; i++) {
        auto it = ep->pend.find(corrs[i]);
        if (it == ep->pend.end() ||
            (ep->stop && it->second.st == P_WAIT) ||
            it->second.st == P_FAIL) {
            out[pos] = 1;
            wr_u32(out + pos + 1, 0);
            if (it != ep->pend.end()) ep->pend.erase(it);
            pos += 5;
        } else if (it->second.st == P_WAIT) {
            out[pos] = 2;
            wr_u32(out + pos + 1, 0);
            pos += 5;
        } else {
            out[pos] = 0;
            wr_u32(out + pos + 1, (uint32_t)it->second.data->size());
            memcpy(out + pos + 5, it->second.data->data(),
                   it->second.data->size());
            pos += 5 + (long)it->second.data->size();
            ep->pend.erase(it);
        }
    }
    return pos;
}

// Queue a reply to an inbound request.  Returns 1 if queued, 0 if the
// connection is gone (the client will retry; the at-most-once cache in
// Python answers without re-execution).
int nl_reply(void* hp, unsigned long long conn_token,
             unsigned long long corr, const uint8_t* data, long len) {
    Ep* ep = (Ep*)hp;
    if (len < 0 || (size_t)len > kMaxFrame) return 0;
    auto frame = std::make_shared<std::vector<uint8_t>>(kHdr + len);
    wr_u32(frame->data(), (uint32_t)len);
    wr_u64(frame->data() + 4, corr);
    memcpy(frame->data() + kHdr, data, (size_t)len);
    std::lock_guard<std::mutex> g(ep->mu);
    if (ep->stop) return 0;
    for (auto& c : ep->conns) {
        if (!c->outbound && c->token == conn_token && !c->dead) {
            c->wq.push_back({frame, 0, 0});
            wake(ep);
            return 1;
        }
    }
    return 0;
}

// Telemetry cursor — atomics only (no mutex, no syscall): safe as a
// PyDLL quick call from any thread, including inside lock regions.
// out[0]=head (next event number), out[1]=heartbeat count,
// out[2]=heartbeat wall-ns.  Returns slots filled.
int nl_tel_cursor(void* hp, unsigned long long* out, int n) {
    Ep* ep = (Ep*)hp;
    int filled = 0;
    if (n > 0) {
        out[0] = ep->tel.head.load(std::memory_order_acquire);
        filled = 1;
    }
    if (n > 1) {
        out[1] = ep->tel.hb_count.load(std::memory_order_relaxed);
        filled = 2;
    }
    if (n > 2) {
        out[2] = ep->tel.hb_wall_ns.load(std::memory_order_relaxed);
        filled = 3;
    }
    return filled;
}

// Bulk-copy events from the caller's cursor into buf (max_events *
// 32 B).  Lock-free but a real memcpy of up to 128 KiB — CDLL class
// (GIL released), never inside a lock region.  Returns events copied;
// *new_tail advances past everything considered, *dropped counts
// events overwritten before/during the copy (see tel_ring.h).
long nl_tel_drain(void* hp, unsigned long long tail, uint8_t* buf,
                  long max_events, unsigned long long* new_tail,
                  unsigned long long* dropped) {
    Ep* ep = (Ep*)hp;
    uint64_t nt = 0, dr = 0;
    long n = ep->tel.drain(tail, buf, max_events, &nt, &dr);
    *new_tail = nt;
    *dropped = dr;
    return n;
}

// Flip event recording (heartbeats keep beating either way) — one
// relaxed atomic store: PyDLL quick class.
void nl_tel_enable(void* hp, int on) {
    ((Ep*)hp)->tel.enabled.store(on ? 1 : 0,
                                 std::memory_order_relaxed);
}

// Stop the event loop and fail every waiter.  Safe to call while other
// threads are blocked in nl_recv / nl_wait — they return closed.  The
// handle stays valid until nl_free.
void nl_shutdown(void* hp) {
    Ep* ep = (Ep*)hp;
    {
        std::lock_guard<std::mutex> g(ep->mu);
        if (ep->stop) return;
        ep->stop = true;
        ep->cv_in.notify_all();
        ep->cv_done.notify_all();
    }
    wake(ep);
    ep->thread.join();
    close(ep->listen_fd);
    close(ep->wake_r);
    close(ep->wake_w);
}

// Free the handle.  Only after nl_shutdown AND after every thread that
// could touch the handle has returned.
void nl_free(void* hp) { delete (Ep*)hp; }

}  // extern "C"

// Native inter-DC publish hub — the erlzmq PUB socket role (reference
// src/inter_dc_pub.erl:87-92 binds a ZMQ PUB via a C NIF; zmq_utils /
// zmq_context are native components of the reference's runtime).
//
// One event thread per hub: accepts subscribers on a listening TCP
// socket, consumes their one-frame hello, and drains per-subscriber
// bounded send queues with non-blocking writes.  The publisher's commit
// path (fab_publish) only copies the frame into each queue — it never
// touches a socket, so a stalled peer costs the publisher nothing; a
// subscriber whose queue overflows is dropped (ZMQ's drop-on-slow PUB
// semantics; the peer resubscribes and gap-repairs).
//
// Framing: 4-byte big-endian length prefix, matching the Python
// transport (antidote_tpu/interdc/tcp.py) byte-for-byte — Python
// subscribers and the native hub interoperate.
//
// C ABI for ctypes (no pybind11 in this environment).

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include "tel_ring.h"

namespace {

constexpr size_t kMaxQueueBytes = 64u << 20;  // per-subscriber cap
constexpr size_t kMaxFrame = 64u << 20;

struct Sub {
    int fd;
    bool hello_done = false;      // first inbound frame pending
    bool dead = false;            // marked by the publisher; only the
                                  // event thread closes fds (fd reuse
                                  // during a poll snapshot would let a
                                  // stale revents hit a new subscriber)
    size_t hello_remaining = 0;   // bytes of hello left to skip
    uint8_t hello_hdr[4];
    size_t hello_hdr_got = 0;
    //: framed bytes (header included), shared across subscribers so a
    //: broadcast is one allocation regardless of fan-out
    std::deque<std::shared_ptr<const std::string>> queue;
    size_t queued_bytes = 0;
    size_t sent_in_head = 0;        // progress within queue.front()
    //: telemetry shadows of `queue` (ISSUE 16): enqueue wall-ns and
    //: publish seq per frame, popped in lockstep — queue-wait latency
    //: and hub frame age come from the front entries
    std::deque<uint64_t> enq_ns;
    std::deque<uint32_t> enq_seq;
};

struct Hub {
    int listen_fd = -1;
    int wake_r = -1, wake_w = -1;   // self-pipe: publisher -> event loop
    uint16_t port = 0;
    std::thread thread;
    std::mutex mu;                  // guards subs' queues + stop flag
    std::vector<std::unique_ptr<Sub>> subs;
    bool stop = false;
    //: flight-recorder ring (ISSUE 16): every emit site below already
    //: holds `mu`, so the ring sees one producer at a time with zero
    //: ADDED mutex crossings on the publish path
    tel::TelRing tel;
    uint64_t pub_seq = 0;           // fab_publish sequence (under mu)
    //: wall-ns of the oldest frame still queued on any subscriber
    //: (0 = none) — refreshed by the event loop each sweep; Python's
    //: drain turns it into the hub-frame-age gauge without locking
    std::atomic<uint64_t> oldest_enq_ns{0};
};

// FNV-1a over the frame payload — the DROP event's last-frame identity
// (low 16 bits).  Computed only on the drop path, never per publish.
uint16_t frame_hash16(const uint8_t* data, int len) {
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < len; i++) {
        h ^= data[i];
        h *= 1099511628211ull;
    }
    return (uint16_t)(h ^ (h >> 16));
}

void set_nonblock(int fd) {
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
}

void wake(Hub* h) {
    uint8_t b = 1;
    ssize_t r = write(h->wake_w, &b, 1);
    (void)r;  // pipe full = loop already awake
}

// Returns false when the subscriber must be dropped.
bool pump_hello(Sub* s) {
    // consume [4-byte len][len bytes] without interpreting it
    while (s->hello_hdr_got < 4) {
        ssize_t r = read(s->fd, s->hello_hdr + s->hello_hdr_got,
                         4 - s->hello_hdr_got);
        if (r == 0) return false;
        if (r < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
        s->hello_hdr_got += (size_t)r;
        if (s->hello_hdr_got == 4) {
            uint32_t n;
            memcpy(&n, s->hello_hdr, 4);
            n = ntohl(n);
            if (n > kMaxFrame) return false;
            s->hello_remaining = n;
        }
    }
    uint8_t buf[4096];
    while (s->hello_remaining > 0) {
        size_t want = s->hello_remaining < sizeof(buf)
                          ? s->hello_remaining : sizeof(buf);
        ssize_t r = read(s->fd, buf, want);
        if (r == 0) return false;
        if (r < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
        s->hello_remaining -= (size_t)r;
    }
    s->hello_done = true;
    return true;
}

// Returns false when the subscriber must be dropped.  Runs on the
// event thread under h->mu; the SUB_DRAIN emit therefore adds no
// mutex crossing of its own.
bool pump_send(Hub* h, Sub* s) {
    while (!s->queue.empty()) {
        const std::string& head = *s->queue.front();
        while (s->sent_in_head < head.size()) {
            ssize_t r = send(s->fd, head.data() + s->sent_in_head,
                             head.size() - s->sent_in_head, MSG_NOSIGNAL);
            if (r < 0) {
                if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
                return false;
            }
            s->sent_in_head += (size_t)r;
        }
        // frame fully on the wire: dur = enqueue -> last byte written
        // (queue wait + send), the subscriber-queue-wait histogram
        if (!s->enq_ns.empty()) {
            h->tel.emit(tel::TEL_EV_SUB_DRAIN, (uint16_t)s->fd,
                        tel::sat_u32(tel::wall_ns() - s->enq_ns.front()),
                        (uint32_t)head.size(), s->enq_seq.front());
            s->enq_ns.pop_front();
            s->enq_seq.pop_front();
        }
        s->queued_bytes -= head.size();
        s->queue.pop_front();
        s->sent_in_head = 0;
    }
    return true;
}

void event_loop(Hub* h) {
    for (;;) {
        h->tel.beat();  // liveness: frozen count+wall = wedged thread
        std::vector<pollfd> pfds;
        pfds.push_back({h->listen_fd, POLLIN, 0});
        pfds.push_back({h->wake_r, POLLIN, 0});
        {
            std::lock_guard<std::mutex> g(h->mu);
            if (h->stop) break;
            // reap publisher-marked subscribers first (queue overflow)
            for (auto it = h->subs.begin(); it != h->subs.end();) {
                if ((*it)->dead) {
                    close((*it)->fd);
                    it = h->subs.erase(it);
                } else {
                    ++it;
                }
            }
            uint64_t oldest = 0;
            for (auto& s : h->subs) {
                short ev = 0;
                if (!s->hello_done) ev |= POLLIN;
                if (!s->queue.empty()) ev |= POLLOUT;
                pfds.push_back({s->fd, ev, 0});
                if (!s->enq_ns.empty() &&
                    (oldest == 0 || s->enq_ns.front() < oldest))
                    oldest = s->enq_ns.front();
            }
            h->oldest_enq_ns.store(oldest, std::memory_order_relaxed);
        }
        if (poll(pfds.data(), pfds.size(), 1000) < 0 && errno != EINTR)
            break;
        // drain wakeups
        if (pfds[1].revents & POLLIN) {
            uint8_t buf[256];
            while (read(h->wake_r, buf, sizeof(buf)) > 0) {
            }
        }
        if (pfds[0].revents & POLLIN) {
            for (;;) {
                int fd = accept(h->listen_fd, nullptr, nullptr);
                if (fd < 0) break;
                set_nonblock(fd);
                int one = 1;
                setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one,
                           sizeof(one));
                auto s = std::make_unique<Sub>();
                s->fd = fd;
                std::lock_guard<std::mutex> g(h->mu);
                h->subs.push_back(std::move(s));
            }
        }
        std::lock_guard<std::mutex> g(h->mu);
        if (h->stop) break;
        // pfds[2 + i] lines up with subs[i] only if the set did not
        // change since the snapshot; match by fd instead
        for (size_t pi = 2; pi < pfds.size(); pi++) {
            if (!pfds[pi].revents) continue;
            for (auto it = h->subs.begin(); it != h->subs.end(); ++it) {
                Sub* s = it->get();
                if (s->fd != pfds[pi].fd) continue;
                if (s->dead) break;
                bool ok = true;
                if (pfds[pi].revents & (POLLERR | POLLHUP | POLLNVAL))
                    ok = false;
                if (ok && (pfds[pi].revents & POLLIN) && !s->hello_done)
                    ok = pump_hello(s);
                if (ok && (pfds[pi].revents & POLLOUT))
                    ok = pump_send(h, s);
                if (!ok) {
                    close(s->fd);
                    h->subs.erase(it);
                }
                break;
            }
        }
    }
    // teardown
    std::lock_guard<std::mutex> g(h->mu);
    for (auto& s : h->subs) close(s->fd);
    h->subs.clear();
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or 0 on failure.
void* fab_create(const char* host, int port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        close(fd);
        return nullptr;
    }
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
        listen(fd, 64) < 0) {
        close(fd);
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, (sockaddr*)&addr, &alen);
    set_nonblock(fd);

    auto* h = new Hub();
    h->listen_fd = fd;
    h->port = ntohs(addr.sin_port);
    int pipefd[2];
    if (pipe(pipefd) < 0) {
        close(fd);
        delete h;
        return nullptr;
    }
    h->wake_r = pipefd[0];
    h->wake_w = pipefd[1];
    set_nonblock(h->wake_r);
    set_nonblock(h->wake_w);
    h->tel.beat();  // a watchdog probing before the thread's first
                    // iteration must see "just born", not "wedged"
    h->thread = std::thread(event_loop, h);
    return h;
}

int fab_port(void* hp) { return ((Hub*)hp)->port; }

// Broadcast one frame; returns the publish SEQUENCE (> 0, monotonic —
// the span-attribution handle telemetry events carry), or -1 on a bad
// length.  Never blocks: the event thread does the socket writes.  The
// per-subscriber queued count rides the PUB_STAGE event's aux16.
long long fab_publish(void* hp, const uint8_t* data, int len) {
    Hub* h = (Hub*)hp;
    if (len < 0 || (size_t)len > kMaxFrame) return -1;
    uint64_t t0 = tel::wall_ns();
    auto framed = std::make_shared<std::string>();
    framed->resize(4 + (size_t)len);
    uint32_t be = htonl((uint32_t)len);
    memcpy(&(*framed)[0], &be, 4);
    memcpy(&(*framed)[4], data, (size_t)len);
    int queued = 0;
    uint64_t seq;
    {
        std::lock_guard<std::mutex> g(h->mu);
        seq = ++h->pub_seq;
        uint64_t enq = tel::wall_ns();
        for (auto& s : h->subs) {
            if (s->dead) continue;
            if (s->queued_bytes + framed->size() > kMaxQueueBytes) {
                // overflowing subscriber: mark for the event thread to
                // drop (resubscribe + gap-repair); never close here
                s->dead = true;
                h->tel.emit(tel::TEL_EV_DROP, frame_hash16(data, len),
                            0, (uint32_t)len, (uint32_t)seq);
                continue;
            }
            s->queue.push_back(framed);
            s->enq_ns.push_back(enq);
            s->enq_seq.push_back((uint32_t)seq);
            s->queued_bytes += framed->size();
            queued++;
            h->tel.emit(tel::TEL_EV_SUB_ENQUEUE, (uint16_t)s->fd, 0,
                        (uint32_t)len, (uint32_t)seq);
        }
        // staging duration: frame copy + fan-out pushes (under mu, so
        // the ring stays single-producer with zero added crossings)
        h->tel.emit(tel::TEL_EV_PUB_STAGE, (uint16_t)queued,
                    tel::sat_u32(tel::wall_ns() - t0), (uint32_t)len,
                    (uint32_t)seq);
    }
    wake(h);
    return (long long)seq;
}

int fab_sub_count(void* hp) {
    Hub* h = (Hub*)hp;
    std::lock_guard<std::mutex> g(h->mu);
    return (int)h->subs.size();
}

// Total bytes queued across every live subscriber's bounded queue —
// the backpressure face of the hub for the FABRIC_* gauges (a rising
// value means a peer is draining slower than the stream publishes).
long long fab_queued_bytes(void* hp) {
    Hub* h = (Hub*)hp;
    std::lock_guard<std::mutex> g(h->mu);
    long long total = 0;
    for (auto& s : h->subs)
        if (!s->dead) total += (long long)s->queued_bytes;
    return total;
}

// Telemetry cursor — atomics only (no mutex, no syscall): safe as a
// PyDLL quick call from any thread, including inside lock regions.
// out[0]=head (next event number), out[1]=heartbeat count,
// out[2]=heartbeat wall-ns, out[3]=oldest queued frame's enqueue
// wall-ns (0 = hub queues empty).  Returns slots filled.
int fab_tel_cursor(void* hp, unsigned long long* out, int n) {
    Hub* h = (Hub*)hp;
    int filled = 0;
    if (n > 0) {
        out[0] = h->tel.head.load(std::memory_order_acquire);
        filled = 1;
    }
    if (n > 1) {
        out[1] = h->tel.hb_count.load(std::memory_order_relaxed);
        filled = 2;
    }
    if (n > 2) {
        out[2] = h->tel.hb_wall_ns.load(std::memory_order_relaxed);
        filled = 3;
    }
    if (n > 3) {
        out[3] = h->oldest_enq_ns.load(std::memory_order_relaxed);
        filled = 4;
    }
    return filled;
}

// Bulk-copy events from the caller's cursor into buf (max_events *
// 32 B).  Lock-free but a real memcpy of up to 128 KiB — CDLL class
// (GIL released), never inside a lock region.  Returns events copied;
// *new_tail advances past everything considered, *dropped counts
// events overwritten before/during the copy (see tel_ring.h).
long fab_tel_drain(void* hp, unsigned long long tail, uint8_t* buf,
                   long max_events, unsigned long long* new_tail,
                   unsigned long long* dropped) {
    Hub* h = (Hub*)hp;
    uint64_t nt = 0, dr = 0;
    long n = h->tel.drain(tail, buf, max_events, &nt, &dr);
    *new_tail = nt;
    *dropped = dr;
    return n;
}

// Flip event recording (heartbeats keep beating either way) — one
// relaxed atomic store: PyDLL quick class.
void fab_tel_enable(void* hp, int on) {
    ((Hub*)hp)->tel.enabled.store(on ? 1 : 0,
                                  std::memory_order_relaxed);
}

void fab_close(void* hp) {
    Hub* h = (Hub*)hp;
    {
        std::lock_guard<std::mutex> g(h->mu);
        h->stop = true;
    }
    wake(h);
    h->thread.join();
    close(h->listen_fd);
    close(h->wake_r);
    close(h->wake_w);
    delete h;
}

}  // extern "C"

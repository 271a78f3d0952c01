// Durable append-only op log — native core.
//
// The reference persists per-partition op logs via Erlang disk_log with
// optional fsync-on-commit (reference src/logging_vnode.erl:896-919,
// :157-162).  This is the C++ equivalent: a single-file append log with
// CRC-framed records, explicit flush/fsync control (buffered appends on
// the update path, sync only on commit), and crash recovery that scans
// to the last valid record and truncates a torn tail.
//
// Record framing: [u32 len][u32 crc32(payload)][payload].
// All integers little-endian.  Exposed through a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t crc32(const uint8_t* buf, size_t len) {
    crc_init();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

struct OpLog {
    int fd = -1;
    FILE* wf = nullptr;     // buffered append stream
    int64_t end = 0;        // logical end (valid data) in bytes
    std::string path;
};

constexpr size_t kHeader = 8;

}  // namespace

extern "C" {

void* oplog_open(const char* path, int create) {
    OpLog* log = new OpLog();
    log->path = path;
    int flags = O_RDWR | (create ? O_CREAT : 0);
    log->fd = ::open(path, flags, 0644);
    if (log->fd < 0) { delete log; return nullptr; }
    log->wf = fdopen(dup(log->fd), "ab");
    if (!log->wf) { ::close(log->fd); delete log; return nullptr; }
    struct stat st;
    fstat(log->fd, &st);
    log->end = st.st_size;
    return log;
}

// Scan from the start, validating framing + CRC; truncate at the first
// corrupt/partial record.  Returns the recovered end offset (-1 on error).
int64_t oplog_recover(void* h) {
    OpLog* log = static_cast<OpLog*>(h);
    struct stat st;
    if (fstat(log->fd, &st) != 0) return -1;
    int64_t size = st.st_size, off = 0;
    uint8_t hdr[kHeader];
    std::string buf;
    while (off + (int64_t)kHeader <= size) {
        if (pread(log->fd, hdr, kHeader, off) != (ssize_t)kHeader) break;
        uint32_t len, crc;
        memcpy(&len, hdr, 4);
        memcpy(&crc, hdr + 4, 4);
        if (len == 0 || off + (int64_t)kHeader + len > size) break;
        buf.resize(len);
        if (pread(log->fd, &buf[0], len, off + kHeader) != (ssize_t)len) break;
        if (crc32(reinterpret_cast<const uint8_t*>(buf.data()), len) != crc)
            break;
        off += kHeader + len;
    }
    if (off < size) {
        if (ftruncate(log->fd, off) != 0) return -1;
    }
    log->end = off;
    // reposition the buffered writer after truncation
    fflush(log->wf);
    fseeko(log->wf, 0, SEEK_END);
    return off;
}

// Like oplog_recover but resumes validation at `start` — a durable
// watermark the caller trusts (a checkpoint cut, ISSUE 10): a torn
// tail can only live at the END of an append-only file, bytes below
// the cut were validated by the run that wrote them, and every later
// read re-checks its record's CRC anyway — so open-time recovery cost
// becomes O(suffix), not O(file).  Returns the recovered end offset;
// -2 when `start` is not a valid record boundary (the caller falls
// back to the full scan — a bogus resume point must never truncate
// good data), -1 on error.
int64_t oplog_recover_from(void* h, int64_t start) {
    OpLog* log = static_cast<OpLog*>(h);
    struct stat st;
    if (fstat(log->fd, &st) != 0) return -1;
    int64_t size = st.st_size, off = start;
    if (start < 0 || start > size) return -2;
    uint8_t hdr[kHeader];
    std::string buf;
    bool validated_one = false;
    while (off + (int64_t)kHeader <= size) {
        if (pread(log->fd, hdr, kHeader, off) != (ssize_t)kHeader) break;
        uint32_t len, crc;
        memcpy(&len, hdr, 4);
        memcpy(&crc, hdr + 4, 4);
        if (len == 0 || off + (int64_t)kHeader + len > size) break;
        buf.resize(len);
        if (pread(log->fd, &buf[0], len, off + kHeader) != (ssize_t)len) break;
        if (crc32(reinterpret_cast<const uint8_t*>(buf.data()), len) != crc)
            break;
        off += kHeader + len;
        validated_one = true;
    }
    if (off < size && !validated_one)
        return -2;  // first suffix record invalid: bogus start or a
                    // tail torn right at the cut — full scan decides
    if (off < size) {
        if (ftruncate(log->fd, off) != 0) return -1;
    }
    log->end = off;
    fflush(log->wf);
    fseeko(log->wf, 0, SEEK_END);
    return off;
}

// Append one record; returns its start offset, or -1.
int64_t oplog_append(void* h, const uint8_t* data, int64_t len) {
    OpLog* log = static_cast<OpLog*>(h);
    uint8_t hdr[kHeader];
    uint32_t len32 = (uint32_t)len;
    uint32_t crc = crc32(data, (size_t)len);
    memcpy(hdr, &len32, 4);
    memcpy(hdr + 4, &crc, 4);
    if (fwrite(hdr, 1, kHeader, log->wf) != kHeader) return -1;
    if (fwrite(data, 1, (size_t)len, log->wf) != (size_t)len) return -1;
    int64_t off = log->end;
    log->end += kHeader + len;
    return off;
}

// Append n records with ONE call and ONE buffered write (the group-
// commit drain's crossing): `data` is the records' payloads
// concatenated, `lens` their lengths.  Each record gets the standard
// [len][crc] frame, so the on-disk bytes are identical to n
// oplog_append calls.  Returns the FIRST record's offset, or -1.
int64_t oplog_append_batch(void* h, const uint8_t* data,
                           const int64_t* lens, int64_t n) {
    OpLog* log = static_cast<OpLog*>(h);
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        if (lens[i] <= 0) return -1;
        total += (int64_t)kHeader + lens[i];
    }
    if (total == 0) return log->end;
    std::string buf;
    buf.reserve((size_t)total);
    const uint8_t* p = data;
    for (int64_t i = 0; i < n; i++) {
        uint32_t len32 = (uint32_t)lens[i];
        uint32_t crc = crc32(p, (size_t)lens[i]);
        buf.append(reinterpret_cast<const char*>(&len32), 4);
        buf.append(reinterpret_cast<const char*>(&crc), 4);
        buf.append(reinterpret_cast<const char*>(p), (size_t)lens[i]);
        p += lens[i];
    }
    if (fwrite(buf.data(), 1, buf.size(), log->wf) != buf.size())
        return -1;
    int64_t off = log->end;
    log->end += total;
    return off;
}

int oplog_flush(void* h) {
    OpLog* log = static_cast<OpLog*>(h);
    return fflush(log->wf) == 0 ? 0 : -1;
}

// fsync-on-commit path (reference ?SYNC_LOG / append_commit).
int oplog_sync(void* h) {
    OpLog* log = static_cast<OpLog*>(h);
    if (fflush(log->wf) != 0) return -1;
    return fsync(log->fd) == 0 ? 0 : -1;
}

int64_t oplog_end_offset(void* h) {
    return static_cast<OpLog*>(h)->end;
}

// Read the record at `offset` into buf (capacity buflen).  Returns the
// payload length (caller retries with a larger buffer if > buflen),
// -1 on EOF/corruption.
int64_t oplog_read(void* h, int64_t offset, uint8_t* buf, int64_t buflen) {
    OpLog* log = static_cast<OpLog*>(h);
    fflush(log->wf);
    if (offset + (int64_t)kHeader > log->end) return -1;
    uint8_t hdr[kHeader];
    if (pread(log->fd, hdr, kHeader, offset) != (ssize_t)kHeader) return -1;
    uint32_t len, crc;
    memcpy(&len, hdr, 4);
    memcpy(&crc, hdr + 4, 4);
    if (offset + (int64_t)kHeader + len > log->end) return -1;
    if ((int64_t)len > buflen) return (int64_t)len;  // tell caller the size
    if (pread(log->fd, buf, len, offset + kHeader) != (ssize_t)len) return -1;
    if (crc32(buf, len) != crc) return -1;
    return (int64_t)len;
}

// Offset of the record following the one at `offset` (-1 past end).
int64_t oplog_next(void* h, int64_t offset) {
    OpLog* log = static_cast<OpLog*>(h);
    if (offset + (int64_t)kHeader > log->end) return -1;
    uint8_t hdr[kHeader];
    if (pread(log->fd, hdr, kHeader, offset) != (ssize_t)kHeader) return -1;
    uint32_t len;
    memcpy(&len, hdr, 4);
    int64_t nxt = offset + kHeader + len;
    return nxt <= log->end ? nxt : -1;
}

void oplog_close(void* h) {
    OpLog* log = static_cast<OpLog*>(h);
    fclose(log->wf);
    ::close(log->fd);
    delete log;
}

}  // extern "C"

// rtsp_plane: consolidated native RTSP ingest at production stream counts.
//
// The reference runs one FFmpeg subprocess per RTSP stream
// (internal/audiocore/ffmpeg/stream.go:471-1534) — at 2,000 streams that
// is 2,000 processes and 2,000 pipe readers. SURVEY §7 flags "2,000
// streams needs a consolidated demux strategy" as a hard part. This is
// that strategy:
//
//   - ONE epoll loop on ONE thread owns every RTSP/TCP-interleaved
//     session: non-blocking connect, the OPTIONS→DESCRIBE→SETUP→PLAY
//     state machine, '$'-framed RTP demultiplexing, payload decode
//     (L16 byte-swap, G.711 µ/A-law table decode + integer upsample),
//     and the per-stream analysis-ring write — zero Python, zero GIL,
//     zero per-stream threads. Sessions self-heal with exponential
//     backoff, exactly like the Python RtspSource / FfmpegSource
//     supervision contract.
//   - Ring + window-packing semantics are IDENTICAL to stream_farm.cpp
//     (AnalysisBuffer overlapped windows, overwrite-with-accounting,
//     striped locks), so bn_rtspd_collect() is a drop-in for
//     bn_farm_collect() in the DeviceLoop fill path.
//   - The demux thread samples its own CLOCK_THREAD_CPUTIME_ID each
//     pass: ingest CPU per stream is a first-class measurement, not an
//     estimate (VERDICT r4 #3 "ingest CPU/stream measured").
//
// A load-generation RTSP SERVER (bn_rtsps_*) lives here too: the same
// epoll pattern serving N L16 sessions from a pre-byteswapped waveform
// bank, paced against CLOCK_MONOTONIC, with per-session output buffers
// that drop whole packets with accounting when a client stalls (what a
// real camera's socket buffer does). It exists so the soak can prove
// the demux at 500+ streams over real TCP/RTSP on one core — it is a
// test rig, not a serving component.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <random>
#include <string>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>

#define BN_API extern "C" __attribute__((visibility("default")))

namespace {

int64_t thread_cpu_ns() {
    timespec ts;
    if (clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts) != 0) return 0;
    return ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

int set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    return fl < 0 ? -1 : fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

// G.711 decode tables (RFC 3551 / Sun g711.c conventions — the same math
// as the Python twin in audio/rtsp.py, table-initialized once).
struct G711Tables {
    int16_t mulaw[256];
    int16_t alaw[256];
    G711Tables() {
        for (int u = 0; u < 256; ++u) {
            int v = ~u & 0xFF;
            int sign = v & 0x80, exp = (v >> 4) & 7, mant = v & 0x0F;
            int s = (((mant << 3) + 0x84) << exp) - 0x84;
            mulaw[u] = static_cast<int16_t>(sign ? -s : s);
        }
        for (int a = 0; a < 256; ++a) {
            int v = a ^ 0x55;
            int sign = v & 0x80, exp = (v >> 4) & 7, mant = v & 0x0F;
            int s = exp == 0 ? (mant << 4) + 8
                             : ((mant << 4) + 0x108) << (exp - 1);
            alaw[a] = static_cast<int16_t>(sign ? s : -s);
        }
    }
};
const G711Tables g711;

// ---------------------------------------------------------------------------
// Demux client
// ---------------------------------------------------------------------------

struct DRing {
    int64_t wpos = 0, rpos = 0, lost = 0, windows = 0, next_index = 0;
    int64_t backlog_hw = 0;
    int64_t t0_ns = -1;     // wall ns (since demux epoch) of first sample —
                            // anchors each window's realtime deadline
};

enum class CState : uint8_t {
    kIdle, kConnecting, kOptions, kDescribe, kSetup, kPlay, kStreaming
};

struct DemuxConn {
    int fd = -1;
    int32_t stream = 0;
    CState state = CState::kIdle;
    std::string host, path;
    int port = 554;
    std::vector<uint8_t> rbuf;
    size_t roff = 0;                 // consumed prefix of rbuf
    std::string session;
    std::string codec;               // "L16" | "PCMU" | "PCMA"
    int in_rate = 0, channels = 1, pt = -1, upsample = 1;
    int cseq = 0;
    int64_t backoff_ms = 1000, next_attempt_ns = 0, connected_at_ns = 0;
    int64_t restarts = 0;
    // linear-upsample continuity: last decoded sample of the previous
    // payload (G.711 8k → 48k interpolates across packet boundaries)
    int16_t last_sample = 0;
    bool has_last = false;
};

struct Demux {
    int64_t n_streams, rate, window, hop, overlap, capacity;
    std::vector<std::unique_ptr<int16_t[]>> rings;
    std::vector<int16_t> tails;
    std::vector<DRing> st;
    std::vector<DemuxConn> conns;
    static constexpr int kStripes = 64;
    std::mutex mu[kStripes];
    std::mutex& stripe(int64_t s) { return mu[s % kStripes]; }
    int64_t rotate = 0;
    int epfd = -1;
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<int64_t> bytes{0}, packets{0}, connected{0}, restarts{0};
    std::atomic<int64_t> cpu_ns{0};
    std::chrono::steady_clock::time_point epoch;
    bool started = false;

    int64_t now_ns() const {
        return std::chrono::duration_cast<std::chrono::nanoseconds>(
                   std::chrono::steady_clock::now() - epoch).count();
    }
};

// Identical overwrite-with-accounting append as stream_farm.cpp
// ring_write_from_bank, but the source is decoded network PCM.
void dring_write(Demux* d, int32_t s, const int16_t* pcm, int64_t n) {
    DRing& r = d->st[static_cast<size_t>(s)];
    int16_t* ring = d->rings[static_cast<size_t>(s)].get();
    const int64_t cap = d->capacity;
    if (r.t0_ns < 0) r.t0_ns = d->now_ns();
    int64_t unread = r.wpos - r.rpos;
    int64_t clobbered = unread + n - cap;
    if (clobbered > 0) {
        int64_t hops = (clobbered + d->hop - 1) / d->hop;
        r.rpos += hops * d->hop;
        r.next_index += hops;
        r.lost += hops * d->hop;
    }
    int64_t done = 0;
    while (done < n) {
        int64_t start = (r.wpos + done) % cap;
        int64_t run = cap - start;
        int64_t m = n - done;
        if (run < m) m = run;
        std::memcpy(ring + start, pcm + done,
                    static_cast<size_t>(m) * sizeof(int16_t));
        done += m;
    }
    r.wpos += n;
    unread = r.wpos - r.rpos;
    if (unread > r.backlog_hw) r.backlog_hw = unread;
}

void conn_close(Demux* d, DemuxConn& c, bool error) {
    if (c.fd >= 0) {
        epoll_ctl(d->epfd, EPOLL_CTL_DEL, c.fd, nullptr);
        ::close(c.fd);
        c.fd = -1;
    }
    if (c.state == CState::kStreaming) {
        d->connected.fetch_sub(1, std::memory_order_relaxed);
    }
    if (error) {
        // quick-exit detection: a session that died soon after connect
        // backs off exponentially; one that streamed a while retries fast
        int64_t ran_ns = d->now_ns() - c.connected_at_ns;
        c.backoff_ms = ran_ns < 5ll * 1000000000ll
                           ? std::min<int64_t>(c.backoff_ms * 2, 30000)
                           : 1000;
        c.next_attempt_ns = d->now_ns() + c.backoff_ms * 1000000ll;
        c.restarts++;
        d->restarts.fetch_add(1, std::memory_order_relaxed);
    }
    c.state = CState::kIdle;
    c.rbuf.clear();
    c.roff = 0;
    c.session.clear();
    c.has_last = false;
}

bool conn_send(Demux* d, DemuxConn& c, const std::string& msg) {
    // Handshake requests are a few hundred bytes — they fit in the socket
    // buffer of a fresh connection; a short write here means the peer is
    // wedged, and reconnect-with-backoff is the right response anyway.
    ssize_t n = ::send(c.fd, msg.data(), msg.size(), MSG_NOSIGNAL);
    if (n != static_cast<ssize_t>(msg.size())) {
        conn_close(d, c, true);
        return false;
    }
    return true;
}

std::string rtsp_url(const DemuxConn& c) {
    char buf[512];
    std::snprintf(buf, sizeof(buf), "rtsp://%s:%d%s", c.host.c_str(),
                  c.port, c.path.c_str());
    return buf;
}

bool send_request(Demux* d, DemuxConn& c, const char* method,
                  const std::string& url, const std::string& extra) {
    char head[256];
    std::snprintf(head, sizeof(head),
                  "%s %s RTSP/1.0\r\nCSeq: %d\r\n"
                  "User-Agent: birdnet-tpu-demux\r\n",
                  method, url.c_str(), ++c.cseq);
    return conn_send(d, c, std::string(head) + extra + "\r\n");
}

void conn_begin(Demux* d, DemuxConn& c) {
    c.fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (c.fd < 0) { conn_close(d, c, true); return; }
    set_nonblock(c.fd);
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(c.port));
    if (inet_pton(AF_INET, c.host.c_str(), &addr.sin_addr) != 1) {
        conn_close(d, c, true);
        return;
    }
    int rc = ::connect(c.fd, reinterpret_cast<sockaddr*>(&addr),
                       sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) { conn_close(d, c, true); return; }
    c.state = CState::kConnecting;
    c.connected_at_ns = d->now_ns();
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u32 = static_cast<uint32_t>(c.stream);
    epoll_ctl(d->epfd, EPOLL_CTL_ADD, c.fd, &ev);
}

// Minimal SDP audio-section parse (the C++ twin of parse_sdp_audio).
bool parse_sdp(DemuxConn& c, const std::string& body) {
    int pt = -1;
    c.codec.clear();
    size_t pos = 0;
    bool in_audio = false;
    while (pos < body.size()) {
        size_t eol = body.find('\n', pos);
        std::string line = body.substr(
            pos, eol == std::string::npos ? std::string::npos : eol - pos);
        pos = eol == std::string::npos ? body.size() : eol + 1;
        while (!line.empty() && (line.back() == '\r' || line.back() == ' '))
            line.pop_back();
        if (line.rfind("m=", 0) == 0) {
            if (line.rfind("m=audio", 0) == 0) {
                in_audio = true;
                // m=audio <port> RTP/AVP <pt>
                size_t sp = line.rfind(' ');
                if (sp != std::string::npos)
                    pt = std::atoi(line.c_str() + sp + 1);
                if (pt == 0) { c.codec = "PCMU"; c.in_rate = 8000;
                               c.channels = 1; }
                if (pt == 8) { c.codec = "PCMA"; c.in_rate = 8000;
                               c.channels = 1; }
                if (pt == 11) { c.codec = "L16"; c.in_rate = 44100;
                                c.channels = 1; }
                if (pt == 10) { c.codec = "L16"; c.in_rate = 44100;
                                c.channels = 2; }
            } else if (in_audio) {
                break;                       // next media section
            }
        } else if (in_audio && line.rfind("a=rtpmap:", 0) == 0) {
            int lpt = std::atoi(line.c_str() + 9);
            if (lpt == pt) {
                size_t sp = line.find(' ');
                if (sp != std::string::npos) {
                    std::string enc = line.substr(sp + 1);
                    size_t s1 = enc.find('/');
                    std::string name = enc.substr(0, s1);
                    for (auto& ch : name) ch = ::toupper(ch);
                    c.codec = name;
                    if (s1 != std::string::npos) {
                        c.in_rate = std::atoi(enc.c_str() + s1 + 1);
                        size_t s2 = enc.find('/', s1 + 1);
                        c.channels = s2 == std::string::npos
                                         ? 1
                                         : std::atoi(enc.c_str() + s2 + 1);
                    }
                }
            }
        }
    }
    c.pt = pt;
    if (c.channels < 1) c.channels = 1;
    return !c.codec.empty() && c.in_rate > 0;
}

// Decode one RTP payload into the stream ring. Returns false on a codec
// the demux can't serve (session fails over to the Python/FFmpeg path).
bool decode_into_ring(Demux* d, DemuxConn& c, const uint8_t* p, size_t n) {
    static thread_local std::vector<int16_t> tmp;
    const int ch = c.channels;
    if (c.codec == "L16") {
        if (c.in_rate != d->rate) return false;   // design note: resample
        size_t ns = n / 2 / static_cast<size_t>(ch);
        if (!ns) return true;
        tmp.resize(ns);
        const uint8_t* q = p;
        if (ch == 1) {
            for (size_t i = 0; i < ns; ++i, q += 2)
                tmp[i] = static_cast<int16_t>((q[0] << 8) | q[1]);
        } else {
            for (size_t i = 0; i < ns; ++i) {
                int acc = 0;
                for (int k = 0; k < ch; ++k, q += 2)
                    acc += static_cast<int16_t>((q[0] << 8) | q[1]);
                tmp[i] = static_cast<int16_t>(acc / ch);
            }
        }
        dring_write(d, c.stream, tmp.data(), static_cast<int64_t>(ns));
        return true;
    }
    if (c.codec == "PCMU" || c.codec == "PCMA") {
        const int16_t* table = c.codec[3] == 'U' ? g711.mulaw : g711.alaw;
        if (d->rate % c.in_rate != 0) return false;
        const int up = static_cast<int>(d->rate / c.in_rate);
        if (up != c.upsample) c.upsample = up;
        size_t ns = n / static_cast<size_t>(ch);
        if (!ns) return true;
        tmp.resize(ns * static_cast<size_t>(up));
        int16_t prev = c.has_last ? c.last_sample : 0;
        size_t o = 0;
        for (size_t i = 0; i < ns; ++i) {
            int acc = 0;
            for (int k = 0; k < ch; ++k) acc += table[p[i * ch + k]];
            int16_t cur = static_cast<int16_t>(acc / ch);
            // linear ramp prev→cur across the upsample factor: telephony-
            // band G.711 has no content above 4 kHz, so linear
            // interpolation to 48 kHz is transparent for detection
            for (int k = 1; k <= up; ++k)
                tmp[o++] = static_cast<int16_t>(
                    prev + (static_cast<int32_t>(cur) - prev) * k / up);
            prev = cur;
        }
        c.last_sample = prev;
        c.has_last = true;
        dring_write(d, c.stream, tmp.data(), static_cast<int64_t>(o));
        return true;
    }
    return false;
}

// Advance the RTSP handshake / pump RTP out of c.rbuf. Returns false if
// the connection was closed.
bool conn_consume(Demux* d, DemuxConn& c) {
    for (;;) {
        const uint8_t* buf = c.rbuf.data() + c.roff;
        size_t avail = c.rbuf.size() - c.roff;
        if (c.state == CState::kStreaming) {
            if (avail < 4) break;
            if (buf[0] != '$') {
                // interleaved RTSP keepalive reply — resync to next '$'
                const void* dollar = std::memchr(buf, '$', avail);
                c.roff += dollar
                    ? static_cast<size_t>(
                          static_cast<const uint8_t*>(dollar) - buf)
                    : avail;
                continue;
            }
            uint8_t chan = buf[1];
            uint16_t len = static_cast<uint16_t>((buf[2] << 8) | buf[3]);
            if (avail < 4u + len) break;
            const uint8_t* pkt = buf + 4;
            c.roff += 4u + len;
            if (chan == 0 && len >= 12) {
                int cc = pkt[0] & 0x0F;
                size_t off = 12 + 4 * static_cast<size_t>(cc);
                if ((pkt[0] & 0x10) && len >= off + 4) {   // extension
                    uint16_t xlen = static_cast<uint16_t>(
                        (pkt[off + 2] << 8) | pkt[off + 3]);
                    off += 4 + 4 * static_cast<size_t>(xlen);
                }
                size_t plen = len > off ? len - off : 0;
                if ((pkt[0] & 0x20) && plen) {             // padding
                    uint8_t pad = pkt[len - 1];
                    if (pad > 0 && pad <= plen) plen -= pad;
                }
                if (plen) {
                    d->packets.fetch_add(1, std::memory_order_relaxed);
                    d->bytes.fetch_add(static_cast<int64_t>(plen),
                                       std::memory_order_relaxed);
                    std::lock_guard<std::mutex> lock(d->stripe(c.stream));
                    if (!decode_into_ring(d, c, pkt + off, plen)) {
                        conn_close(d, c, true);
                        return false;
                    }
                }
            }
            continue;
        }
        // handshake: need a full response head
        const char* head_end = nullptr;
        for (size_t i = 0; i + 3 < avail; ++i) {
            if (buf[i] == '\r' && buf[i + 1] == '\n' && buf[i + 2] == '\r'
                && buf[i + 3] == '\n') {
                head_end = reinterpret_cast<const char*>(buf + i);
                break;
            }
        }
        if (!head_end) break;
        size_t head_len =
            static_cast<size_t>(reinterpret_cast<const uint8_t*>(head_end)
                                - buf);
        std::string head(reinterpret_cast<const char*>(buf), head_len);
        // status + Content-Length + Session
        int status = 0;
        size_t sp = head.find(' ');
        if (sp != std::string::npos)
            status = std::atoi(head.c_str() + sp + 1);
        size_t clen = 0;
        {
            std::string lower;
            lower.reserve(head.size());
            for (char ch : head)
                lower.push_back(static_cast<char>(::tolower(ch)));
            size_t cl = lower.find("content-length:");
            if (cl != std::string::npos)
                clen = static_cast<size_t>(
                    std::atoll(head.c_str() + cl + 15));
            if (c.state == CState::kSetup) {
                size_t se = lower.find("session:");
                if (se != std::string::npos) {
                    size_t end = head.find_first_of(";\r\n", se + 8);
                    std::string sess = head.substr(
                        se + 8, end == std::string::npos ? std::string::npos
                                                         : end - (se + 8));
                    size_t b = sess.find_first_not_of(' ');
                    c.session = b == std::string::npos ? "" : sess.substr(b);
                }
            }
        }
        if (avail < head_len + 4 + clen) break;            // body pending
        std::string body(reinterpret_cast<const char*>(buf) + head_len + 4,
                         clen);
        c.roff += head_len + 4 + clen;
        if (status != 200) { conn_close(d, c, true); return false; }
        const std::string url = rtsp_url(c);
        switch (c.state) {
            case CState::kOptions:
                c.state = CState::kDescribe;
                if (!send_request(d, c, "DESCRIBE", url,
                                  "Accept: application/sdp\r\n"))
                    return false;
                break;
            case CState::kDescribe: {
                if (!parse_sdp(c, body)) {
                    conn_close(d, c, true);
                    return false;
                }
                c.state = CState::kSetup;
                if (!send_request(
                        d, c, "SETUP", url + "/streamid=0",
                        "Transport: RTP/AVP/TCP;unicast;interleaved=0-1"
                        "\r\n"))
                    return false;
                break;
            }
            case CState::kSetup:
                c.state = CState::kPlay;
                if (!send_request(d, c, "PLAY", url,
                                  "Session: " + c.session
                                      + "\r\nRange: npt=0.000-\r\n"))
                    return false;
                break;
            case CState::kPlay:
                c.state = CState::kStreaming;
                c.backoff_ms = 1000;
                d->connected.fetch_add(1, std::memory_order_relaxed);
                break;
            default:
                conn_close(d, c, true);
                return false;
        }
    }
    // compact the consumed prefix (bounded memory per connection)
    if (c.roff > 0) {
        if (c.roff == c.rbuf.size()) {
            c.rbuf.clear();
        } else if (c.roff > 4096) {
            c.rbuf.erase(c.rbuf.begin(),
                         c.rbuf.begin() + static_cast<long>(c.roff));
        } else {
            return true;                     // defer tiny compactions
        }
        c.roff = 0;
    }
    return true;
}

void demux_main(Demux* d) {
    std::vector<epoll_event> evs(256);
    uint8_t io[65536];
    while (!d->stop.load(std::memory_order_relaxed)) {
        const int64_t now = d->now_ns();
        for (auto& c : d->conns) {
            if (c.state == CState::kIdle && !c.host.empty()
                && now >= c.next_attempt_ns) {
                conn_begin(d, c);
            }
        }
        int n = epoll_wait(d->epfd, evs.data(),
                           static_cast<int>(evs.size()), 20);
        for (int i = 0; i < n; ++i) {
            auto& c = d->conns[evs[i].data.u32];
            if (c.fd < 0) continue;
            if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
                conn_close(d, c, true);
                continue;
            }
            if (c.state == CState::kConnecting
                && (evs[i].events & EPOLLOUT)) {
                int err = 0;
                socklen_t elen = sizeof(err);
                getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &elen);
                if (err != 0) { conn_close(d, c, true); continue; }
                // connected: handshake is read-driven from here
                epoll_event ev{};
                ev.events = EPOLLIN;
                ev.data.u32 = static_cast<uint32_t>(c.stream);
                epoll_ctl(d->epfd, EPOLL_CTL_MOD, c.fd, &ev);
                c.state = CState::kOptions;
                if (!send_request(d, c, "OPTIONS", rtsp_url(c), ""))
                    continue;
            }
            if (evs[i].events & EPOLLIN) {
                for (;;) {
                    ssize_t got = ::recv(c.fd, io, sizeof(io), 0);
                    if (got > 0) {
                        c.rbuf.insert(c.rbuf.end(), io, io + got);
                        if (got < static_cast<ssize_t>(sizeof(io))) break;
                    } else if (got == 0) {
                        conn_close(d, c, true);
                        break;
                    } else {
                        if (errno != EAGAIN && errno != EWOULDBLOCK)
                            conn_close(d, c, true);
                        break;
                    }
                }
                if (c.fd >= 0 && !c.rbuf.empty()) conn_consume(d, c);
            }
        }
        d->cpu_ns.store(thread_cpu_ns(), std::memory_order_relaxed);
    }
    // teardown: best-effort TEARDOWN then close (fire and forget)
    for (auto& c : d->conns) {
        if (c.fd >= 0 && c.state == CState::kStreaming
            && !c.session.empty()) {
            char msg[384];
            std::snprintf(msg, sizeof(msg),
                          "TEARDOWN %s RTSP/1.0\r\nCSeq: %d\r\n"
                          "Session: %s\r\n\r\n",
                          rtsp_url(c).c_str(), ++c.cseq, c.session.c_str());
            ::send(c.fd, msg, std::strlen(msg), MSG_NOSIGNAL);
        }
        conn_close(d, c, false);
    }
}

}  // namespace

BN_API void* bn_rtspd_create(int64_t n_streams, int64_t rate,
                             int64_t window, int64_t hop,
                             double ring_seconds) {
    if (n_streams <= 0 || n_streams > (1 << 24) || rate <= 0 || window <= 0
        || hop <= 0 || hop > window) {
        return nullptr;
    }
    auto* d = new (std::nothrow) Demux();
    if (!d) return nullptr;
    d->n_streams = n_streams;
    d->rate = rate;
    d->window = window;
    d->hop = hop;
    d->overlap = window - hop;
    int64_t cap = static_cast<int64_t>(ring_seconds * rate);
    d->capacity = cap > 2 * window ? cap : 2 * window;
    d->epfd = epoll_create1(0);
    if (d->epfd < 0) { delete d; return nullptr; }
    try {
        d->rings.resize(static_cast<size_t>(n_streams));
        for (int64_t s = 0; s < n_streams; ++s) {
            d->rings[static_cast<size_t>(s)].reset(
                new int16_t[static_cast<size_t>(d->capacity)]());
        }
        d->tails.assign(static_cast<size_t>(n_streams * d->overlap), 0);
        d->st.resize(static_cast<size_t>(n_streams));
        d->conns.resize(static_cast<size_t>(n_streams));
    } catch (const std::bad_alloc&) {
        ::close(d->epfd);
        delete d;
        return nullptr;
    }
    for (int64_t s = 0; s < n_streams; ++s)
        d->conns[static_cast<size_t>(s)].stream = static_cast<int32_t>(s);
    d->epoch = std::chrono::steady_clock::now();
    return d;
}

BN_API int bn_rtspd_add(void* h, int64_t idx, const char* host,
                        int64_t port, const char* path) {
    auto* d = static_cast<Demux*>(h);
    if (!d || d->started || idx < 0 || idx >= d->n_streams || !host)
        return 0;
    DemuxConn& c = d->conns[static_cast<size_t>(idx)];
    c.host = host;
    c.port = static_cast<int>(port);
    c.path = path && path[0] ? path : "/";
    // stagger initial connects: all-at-once SYN floods the accept queue
    // and synchronizes every stream's window phase (same rationale as
    // stream_farm stagger_hops)
    c.next_attempt_ns = (idx % 97) * 20000000ll;   // 0..1.9 s spread
    return 1;
}

BN_API int bn_rtspd_start(void* h) {
    auto* d = static_cast<Demux*>(h);
    if (!d || d->started) return 0;
    d->stop.store(false);
    d->epoch = std::chrono::steady_clock::now();
    d->started = true;
    try {
        d->th = std::thread(demux_main, d);
    } catch (const std::system_error&) {
        d->started = false;
        return 0;
    }
    return 1;
}

BN_API void bn_rtspd_stop(void* h) {
    auto* d = static_cast<Demux*>(h);
    if (!d || !d->started) return;
    d->stop.store(true);
    if (d->th.joinable()) d->th.join();
    d->started = false;
}

BN_API void bn_rtspd_destroy(void* h) {
    auto* d = static_cast<Demux*>(h);
    if (!d) return;
    bn_rtspd_stop(d);
    if (d->epfd >= 0) ::close(d->epfd);
    delete d;
}

// Window packing — byte-identical semantics to bn_farm_collect. meta:
// (stream_id, window_index, ready_ns) where ready_ns anchors at the
// stream's first-sample arrival plus nominal realtime pacing — the
// deadline serving latency is measured against.
BN_API int64_t bn_rtspd_collect(void* h, int16_t* out, int64_t* meta,
                                int64_t max_windows) {
    auto* d = static_cast<Demux*>(h);
    if (!d || !out || max_windows <= 0) return 0;
    int64_t count = 0;
    for (int64_t k = 0; k < d->n_streams && count < max_windows; ++k) {
        int64_t s = (k + d->rotate) % d->n_streams;
        std::lock_guard<std::mutex> lock(d->stripe(s));
        DRing& r = d->st[static_cast<size_t>(s)];
        int16_t* ring = d->rings[static_cast<size_t>(s)].get();
        int16_t* tail = d->tails.data() + s * d->overlap;
        while (count < max_windows && r.wpos - r.rpos >= d->hop) {
            int16_t* w = out + count * d->window;
            std::memcpy(w, tail,
                        static_cast<size_t>(d->overlap) * sizeof(int16_t));
            int64_t start = r.rpos % d->capacity;
            int64_t first = d->capacity - start;
            if (first > d->hop) first = d->hop;
            std::memcpy(w + d->overlap, ring + start,
                        static_cast<size_t>(first) * sizeof(int16_t));
            if (d->hop > first) {
                std::memcpy(w + d->overlap + first, ring,
                            static_cast<size_t>(d->hop - first)
                                * sizeof(int16_t));
            }
            if (d->overlap > 0) {
                std::memcpy(tail, w + (d->window - d->overlap),
                            static_cast<size_t>(d->overlap)
                                * sizeof(int16_t));
            }
            r.rpos += d->hop;
            if (meta) {
                meta[3 * count] = s;
                meta[3 * count + 1] = r.next_index;
                meta[3 * count + 2] =
                    r.t0_ns
                    + static_cast<int64_t>(
                          static_cast<double>((r.next_index + 1) * d->hop)
                          / d->rate * 1e9);
            }
            ++r.next_index;
            ++r.windows;
            ++count;
        }
    }
    d->rotate = (d->rotate + 1) % d->n_streams;
    return count;
}

// stats out[12]: samples_received, windows_emitted, samples_lost,
// ready_windows, connected, restarts, bytes, packets, backlog_hw,
// demux_thread_cpu_ns, n_streams, ring_capacity
BN_API void bn_rtspd_stats(void* h, int64_t* out) {
    auto* d = static_cast<Demux*>(h);
    if (!d || !out) return;
    int64_t samples = 0, windows = 0, lost = 0, ready = 0, hw = 0;
    for (int64_t s = 0; s < d->n_streams; ++s) {
        std::lock_guard<std::mutex> lock(d->stripe(s));
        const DRing& r = d->st[static_cast<size_t>(s)];
        samples += r.wpos;
        windows += r.windows;
        lost += r.lost;
        ready += (r.wpos - r.rpos) / d->hop;
        if (r.backlog_hw > hw) hw = r.backlog_hw;
    }
    out[0] = samples;
    out[1] = windows;
    out[2] = lost;
    out[3] = ready;
    out[4] = d->connected.load(std::memory_order_relaxed);
    out[5] = d->restarts.load(std::memory_order_relaxed);
    out[6] = d->bytes.load(std::memory_order_relaxed);
    out[7] = d->packets.load(std::memory_order_relaxed);
    out[8] = hw;
    out[9] = d->cpu_ns.load(std::memory_order_relaxed);
    out[10] = d->n_streams;
    out[11] = d->capacity;
}

// ---------------------------------------------------------------------------
// Load-generation RTSP server (test rig)
// ---------------------------------------------------------------------------

namespace {

struct SrvSess {
    int fd = -1;
    std::vector<uint8_t> rbuf;
    std::string outbuf;
    size_t ooff = 0;
    bool playing = false;
    int wave = 0;
    int64_t phase = 0;           // sample position in the waveform (loops)
    int64_t sent = 0;            // samples whose packets were built
    int64_t dropped = 0;         // samples dropped (client stalled)
    uint16_t seq = 0;
    uint32_t ssrc = 0, rtp_ts = 0;
    std::chrono::steady_clock::time_point t0;
};

struct Srv {
    int lfd = -1, epfd = -1, port = 0;
    int64_t rate;
    int64_t pkt_samples;
    std::vector<std::vector<int16_t>> bank;      // big-endian pre-swapped
    std::unordered_map<int, SrvSess> sess;
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<int64_t> accepted{0}, playing{0}, samples_sent{0},
        samples_dropped{0}, cpu_ns{0};
    int wave_rr = 0;
    std::mt19937_64 rng{12345};
};

void srv_build_bank(Srv* s, int64_t n_waveforms, uint64_t seed) {
    s->bank.resize(static_cast<size_t>(n_waveforms));
    for (int64_t i = 0; i < n_waveforms; ++i) {
        std::mt19937_64 rng(seed * 2654435761u + static_cast<uint64_t>(i));
        std::uniform_real_distribution<double> f0d(400.0, 8000.0);
        const double f0 = f0d(rng);
        const int64_t n = s->rate * 2;
        auto& w = s->bank[static_cast<size_t>(i)];
        w.resize(static_cast<size_t>(n));
        for (int64_t t = 0; t < n; ++t) {
            double x = 0.3 * std::sin(2 * M_PI * f0 * t / s->rate)
                     + 0.12 * std::sin(2 * M_PI * 2 * f0 * t / s->rate);
            int16_t v = static_cast<int16_t>(x * 32767.0);
            // pre-swap to network byte order: steady-state packet build
            // is then a straight memcpy from the bank
            w[static_cast<size_t>(t)] = static_cast<int16_t>(
                ((v & 0xFF) << 8) | ((v >> 8) & 0xFF));
        }
    }
}

void srv_close(Srv* s, int fd) {
    auto it = s->sess.find(fd);
    if (it == s->sess.end()) return;
    if (it->second.playing)
        s->playing.fetch_sub(1, std::memory_order_relaxed);
    epoll_ctl(s->epfd, EPOLL_CTL_DEL, fd, nullptr);
    ::close(fd);
    s->sess.erase(it);
}

void srv_flush(Srv*, SrvSess& c) {
    while (c.ooff < c.outbuf.size()) {
        ssize_t n = ::send(c.fd, c.outbuf.data() + c.ooff,
                           c.outbuf.size() - c.ooff, MSG_NOSIGNAL);
        if (n > 0) {
            c.ooff += static_cast<size_t>(n);
        } else {
            break;           // EAGAIN (or error caught by epoll later)
        }
    }
    if (c.ooff == c.outbuf.size()) {
        c.outbuf.clear();
        c.ooff = 0;
    } else if (c.ooff > (1 << 16)) {
        c.outbuf.erase(0, c.ooff);
        c.ooff = 0;
    }
}

void srv_handle_request(Srv* s, SrvSess& c) {
    for (;;) {
        auto it = std::search(c.rbuf.begin(), c.rbuf.end(),
                              reinterpret_cast<const uint8_t*>("\r\n\r\n"),
                              reinterpret_cast<const uint8_t*>("\r\n\r\n")
                                  + 4);
        if (it == c.rbuf.end()) return;
        std::string head(c.rbuf.begin(), it);
        c.rbuf.erase(c.rbuf.begin(), it + 4);
        std::string method = head.substr(0, head.find(' '));
        std::string cseq = "0";
        {
            std::string lower;
            for (char ch : head)
                lower.push_back(static_cast<char>(::tolower(ch)));
            size_t p = lower.find("cseq:");
            if (p != std::string::npos) {
                size_t e = head.find("\r\n", p);
                cseq = head.substr(p + 5, e - p - 5);
                size_t b = cseq.find_first_not_of(' ');
                if (b != std::string::npos) cseq = cseq.substr(b);
            }
        }
        char resp[1024];
        if (method == "OPTIONS") {
            std::snprintf(resp, sizeof(resp),
                          "RTSP/1.0 200 OK\r\nCSeq: %s\r\nPublic: "
                          "OPTIONS, DESCRIBE, SETUP, PLAY, TEARDOWN\r\n\r\n",
                          cseq.c_str());
            c.outbuf += resp;
        } else if (method == "DESCRIBE") {
            char sdp[512];
            std::snprintf(sdp, sizeof(sdp),
                          "v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\n"
                          "s=birdnet-loadgen\r\nt=0 0\r\n"
                          "m=audio 0 RTP/AVP 96\r\n"
                          "a=rtpmap:96 L16/%lld/1\r\n"
                          "a=control:streamid=0\r\n",
                          static_cast<long long>(s->rate));
            std::snprintf(resp, sizeof(resp),
                          "RTSP/1.0 200 OK\r\nCSeq: %s\r\n"
                          "Content-Type: application/sdp\r\n"
                          "Content-Length: %zu\r\n\r\n%s",
                          cseq.c_str(), std::strlen(sdp), sdp);
            c.outbuf += resp;
        } else if (method == "SETUP") {
            std::snprintf(resp, sizeof(resp),
                          "RTSP/1.0 200 OK\r\nCSeq: %s\r\n"
                          "Session: %08x;timeout=60\r\n"
                          "Transport: RTP/AVP/TCP;unicast;"
                          "interleaved=0-1\r\n\r\n",
                          cseq.c_str(), static_cast<unsigned>(c.ssrc));
            c.outbuf += resp;
        } else if (method == "PLAY") {
            std::snprintf(resp, sizeof(resp),
                          "RTSP/1.0 200 OK\r\nCSeq: %s\r\n"
                          "Session: %08x\r\nRange: npt=0.000-\r\n\r\n",
                          cseq.c_str(), static_cast<unsigned>(c.ssrc));
            c.outbuf += resp;
            if (!c.playing) {
                c.playing = true;
                c.t0 = std::chrono::steady_clock::now();
                c.wave = s->wave_rr++
                         % static_cast<int>(s->bank.size());
                c.phase = static_cast<int64_t>(
                    s->rng() % static_cast<uint64_t>(s->rate));
                s->playing.fetch_add(1, std::memory_order_relaxed);
            }
        } else {                                          // TEARDOWN & co
            std::snprintf(resp, sizeof(resp),
                          "RTSP/1.0 200 OK\r\nCSeq: %s\r\n\r\n",
                          cseq.c_str());
            c.outbuf += resp;
        }
    }
}

void srv_pace(Srv* s, SrvSess& c) {
    if (!c.playing) return;
    const double elapsed = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - c.t0).count();
    int64_t target = static_cast<int64_t>(elapsed * s->rate);
    int64_t need = target - c.sent;
    if (need <= 0) return;
    if (need > s->rate) need = s->rate;     // catch-up bound: 1 s/pass
    const auto& w = s->bank[static_cast<size_t>(c.wave)];
    const int64_t wlen = static_cast<int64_t>(w.size());
    while (need > 0) {
        int64_t n = need < s->pkt_samples ? need : s->pkt_samples;
        // a stalled client gets whole packets dropped with accounting —
        // the bounded-queue contract, same as a camera's socket buffer
        if (c.outbuf.size() - c.ooff > (1u << 20)) {
            c.dropped += n;
            s->samples_dropped.fetch_add(n, std::memory_order_relaxed);
        } else {
            char hdr[16];
            uint16_t plen = static_cast<uint16_t>(12 + n * 2);
            hdr[0] = '$';
            hdr[1] = 0;
            hdr[2] = static_cast<char>(plen >> 8);
            hdr[3] = static_cast<char>(plen & 0xFF);
            hdr[4] = static_cast<char>(0x80);             // V=2
            hdr[5] = 96;                                  // PT dynamic
            hdr[6] = static_cast<char>(c.seq >> 8);
            hdr[7] = static_cast<char>(c.seq & 0xFF);
            uint32_t ts = c.rtp_ts;
            hdr[8] = static_cast<char>(ts >> 24);
            hdr[9] = static_cast<char>(ts >> 16);
            hdr[10] = static_cast<char>(ts >> 8);
            hdr[11] = static_cast<char>(ts & 0xFF);
            uint32_t ssrc = c.ssrc;
            hdr[12] = static_cast<char>(ssrc >> 24);
            hdr[13] = static_cast<char>(ssrc >> 16);
            hdr[14] = static_cast<char>(ssrc >> 8);
            hdr[15] = static_cast<char>(ssrc & 0xFF);
            c.outbuf.append(hdr, 16);
            int64_t done = 0;
            while (done < n) {
                int64_t src = c.phase % wlen;
                int64_t run = wlen - src;
                int64_t m = n - done;
                if (run < m) m = run;
                c.outbuf.append(
                    reinterpret_cast<const char*>(w.data() + src),
                    static_cast<size_t>(m) * 2);
                c.phase += m;
                done += m;
            }
            s->samples_sent.fetch_add(n, std::memory_order_relaxed);
        }
        c.seq++;
        c.rtp_ts += static_cast<uint32_t>(n);
        c.sent += n;
        need -= n;
    }
    srv_flush(s, c);
}

void srv_main(Srv* s) {
    std::vector<epoll_event> evs(256);
    uint8_t io[65536];
    while (!s->stop.load(std::memory_order_relaxed)) {
        int n = epoll_wait(s->epfd, evs.data(),
                           static_cast<int>(evs.size()), 25);
        for (int i = 0; i < n; ++i) {
            int fd = evs[i].data.fd;
            if (fd == s->lfd) {
                for (;;) {
                    int cfd = ::accept(s->lfd, nullptr, nullptr);
                    if (cfd < 0) break;
                    set_nonblock(cfd);
                    int one = 1;
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof(one));
                    SrvSess c;
                    c.fd = cfd;
                    c.ssrc = static_cast<uint32_t>(s->rng());
                    s->sess.emplace(cfd, std::move(c));
                    s->accepted.fetch_add(1, std::memory_order_relaxed);
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.fd = cfd;
                    epoll_ctl(s->epfd, EPOLL_CTL_ADD, cfd, &ev);
                }
                continue;
            }
            auto it = s->sess.find(fd);
            if (it == s->sess.end()) continue;
            if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
                srv_close(s, fd);
                continue;
            }
            if (evs[i].events & EPOLLIN) {
                for (;;) {
                    ssize_t got = ::recv(fd, io, sizeof(io), 0);
                    if (got > 0) {
                        it->second.rbuf.insert(it->second.rbuf.end(), io,
                                               io + got);
                        if (got < static_cast<ssize_t>(sizeof(io))) break;
                    } else if (got == 0) {
                        srv_close(s, fd);
                        break;
                    } else {
                        if (errno != EAGAIN && errno != EWOULDBLOCK)
                            srv_close(s, fd);
                        break;
                    }
                }
                auto it2 = s->sess.find(fd);
                if (it2 != s->sess.end()) {
                    srv_handle_request(s, it2->second);
                    srv_flush(s, it2->second);
                }
            }
        }
        // pacing pass: every playing session advances to wall-clock target
        for (auto& kv : s->sess) srv_pace(s, kv.second);
        s->cpu_ns.store(thread_cpu_ns(), std::memory_order_relaxed);
    }
    for (auto& kv : s->sess) ::close(kv.first);
    s->sess.clear();
}

}  // namespace

BN_API void* bn_rtsps_create(int64_t port, int64_t rate,
                             int64_t n_waveforms, uint64_t seed,
                             int64_t pkt_ms) {
    auto* s = new (std::nothrow) Srv();
    if (!s) return nullptr;
    s->rate = rate > 0 ? rate : 48000;
    if (pkt_ms <= 0) pkt_ms = 50;
    s->pkt_samples = s->rate * pkt_ms / 1000;
    if (s->pkt_samples * 2 + 12 > 65000)
        s->pkt_samples = (65000 - 12) / 2;
    if (n_waveforms <= 0) n_waveforms = 8;
    srv_build_bank(s, n_waveforms, seed ? seed : 1);
    s->lfd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (s->lfd < 0) { delete s; return nullptr; }
    int one = 1;
    setsockopt(s->lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(s->lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0
        || ::listen(s->lfd, 1024) < 0) {
        ::close(s->lfd);
        delete s;
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(s->lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
    s->port = ntohs(addr.sin_port);
    set_nonblock(s->lfd);
    s->epfd = epoll_create1(0);
    if (s->epfd < 0) {
        ::close(s->lfd);
        delete s;
        return nullptr;
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = s->lfd;
    epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->lfd, &ev);
    return s;
}

BN_API int64_t bn_rtsps_port(void* h) {
    auto* s = static_cast<Srv*>(h);
    return s ? s->port : 0;
}

BN_API int bn_rtsps_start(void* h) {
    auto* s = static_cast<Srv*>(h);
    if (!s || s->th.joinable()) return 0;
    s->stop.store(false);
    try {
        s->th = std::thread(srv_main, s);
    } catch (const std::system_error&) {
        return 0;
    }
    return 1;
}

BN_API void bn_rtsps_stop(void* h) {
    auto* s = static_cast<Srv*>(h);
    if (!s) return;
    s->stop.store(true);
    if (s->th.joinable()) s->th.join();
}

BN_API void bn_rtsps_destroy(void* h) {
    auto* s = static_cast<Srv*>(h);
    if (!s) return;
    bn_rtsps_stop(s);
    if (s->epfd >= 0) ::close(s->epfd);
    if (s->lfd >= 0) ::close(s->lfd);
    delete s;
}

// stats out[6]: accepted, playing, samples_sent, samples_dropped,
// server_thread_cpu_ns, port
BN_API void bn_rtsps_stats(void* h, int64_t* out) {
    auto* s = static_cast<Srv*>(h);
    if (!s || !out) return;
    out[0] = s->accepted.load(std::memory_order_relaxed);
    out[1] = s->playing.load(std::memory_order_relaxed);
    out[2] = s->samples_sent.load(std::memory_order_relaxed);
    out[3] = s->samples_dropped.load(std::memory_order_relaxed);
    out[4] = s->cpu_ns.load(std::memory_order_relaxed);
    out[5] = s->port;
}

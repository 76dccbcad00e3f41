// birdnet_host: native host data plane for the device pipeline.
//
// Replaces the reference's native host components (SURVEY.md §2.8):
//  - malgo/miniaudio CGO capture  -> ALSA capture via dlopen(libasound)
//    (graceful absence, mirroring the reference's OpenVINO dlopen pattern,
//    internal/inference/openvino/backend_openvino.go)
//  - Go ring buffers on the hot path -> lock-guarded int16 ring buffers
//    with the exact AnalysisBuffer overlapped-window semantics
//    (internal/audiocore/buffer/analysis.go:187-252)
//  - glibc mallopt arena cap (internal/mempolicy/arena_linux.go:16-27)
//
// C ABI only — consumed from Python via ctypes (no pybind11 in the image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <string>
#include <vector>

#include <dlfcn.h>
#include <malloc.h>

#define BN_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// Analysis ring buffer (per (source, model)).
//
// Semantics (must match the Python AnalysisBuffer for drop-in use):
//  - write(): appends int16 samples; if a write would clobber unread data
//    the read position advances (overwrite), counted in `lost`; writes
//    larger than capacity keep only the freshest tail (head counted lost).
//  - read(): returns a window = [overlap tail of previous window | fresh
//    read_size samples], or 0 if not enough fresh audio; the first
//    window's overlap prefix is zeros.
// ---------------------------------------------------------------------------

struct AnalysisRing {
    int64_t overlap;
    int64_t read_size;
    int64_t capacity;
    std::vector<int16_t> ring;
    std::vector<int16_t> prev_tail;
    int64_t wpos = 0;   // absolute samples written
    int64_t rpos = 0;   // absolute samples consumed
    int64_t lost = 0;   // overwritten + truncated samples
    std::mutex mu;
};

BN_API void* bn_ring_create(int64_t overlap, int64_t read_size,
                            int64_t capacity) {
    if (read_size <= 0 || overlap < 0) return nullptr;
    auto* r = new (std::nothrow) AnalysisRing();
    if (!r) return nullptr;
    r->overlap = overlap;
    r->read_size = read_size;
    int64_t window = overlap + read_size;
    r->capacity = capacity > window ? capacity : 2 * window;
    r->ring.assign(static_cast<size_t>(r->capacity), 0);
    r->prev_tail.assign(static_cast<size_t>(overlap), 0);
    return r;
}

BN_API void bn_ring_destroy(void* h) {
    delete static_cast<AnalysisRing*>(h);
}

BN_API void bn_ring_write(void* h, const int16_t* data, int64_t n) {
    auto* r = static_cast<AnalysisRing*>(h);
    if (!r || n <= 0) return;
    std::lock_guard<std::mutex> lock(r->mu);
    int64_t truncated = 0;
    if (n > r->capacity) {
        truncated = n - r->capacity;
        data += truncated;
        n = r->capacity;
    }
    int64_t unread = r->wpos - r->rpos;
    int64_t clobbered = unread + n - r->capacity;
    if (clobbered < 0) clobbered = 0;
    r->rpos += clobbered;
    r->lost += truncated + clobbered;
    int64_t start = r->wpos % r->capacity;
    int64_t first = r->capacity - start;
    if (first > n) first = n;
    std::memcpy(r->ring.data() + start, data,
                static_cast<size_t>(first) * sizeof(int16_t));
    if (n > first) {
        std::memcpy(r->ring.data(), data + first,
                    static_cast<size_t>(n - first) * sizeof(int16_t));
    }
    r->wpos += n;
}

// Returns window length (overlap+read_size) on success, 0 if not ready.
BN_API int64_t bn_ring_read(void* h, int16_t* out) {
    auto* r = static_cast<AnalysisRing*>(h);
    if (!r) return 0;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->wpos - r->rpos < r->read_size) return 0;
    // overlap prefix from the previous window's tail
    std::memcpy(out, r->prev_tail.data(),
                static_cast<size_t>(r->overlap) * sizeof(int16_t));
    // fresh region
    int64_t start = r->rpos % r->capacity;
    int64_t first = r->capacity - start;
    if (first > r->read_size) first = r->read_size;
    std::memcpy(out + r->overlap, r->ring.data() + start,
                static_cast<size_t>(first) * sizeof(int16_t));
    if (r->read_size > first) {
        std::memcpy(out + r->overlap + first, r->ring.data(),
                    static_cast<size_t>(r->read_size - first)
                        * sizeof(int16_t));
    }
    r->rpos += r->read_size;
    int64_t window = r->overlap + r->read_size;
    if (r->overlap > 0) {
        std::memcpy(r->prev_tail.data(), out + (window - r->overlap),
                    static_cast<size_t>(r->overlap) * sizeof(int16_t));
    }
    return window;
}

// Batch drain: read up to max_windows windows into a contiguous buffer.
// Returns the number of windows written. This is the hot-path call the
// scheduler uses each tick — one FFI crossing per (buffer, tick) instead
// of per window.
BN_API int64_t bn_ring_read_batch(void* h, int16_t* out,
                                  int64_t max_windows) {
    auto* r = static_cast<AnalysisRing*>(h);
    if (!r) return 0;
    int64_t window = r->overlap + r->read_size;
    int64_t count = 0;
    while (count < max_windows) {
        if (bn_ring_read(h, out + count * window) == 0) break;
        ++count;
    }
    return count;
}

BN_API int64_t bn_ring_available(void* h) {
    auto* r = static_cast<AnalysisRing*>(h);
    if (!r) return 0;                   // same graceful no-op as read/write
    std::lock_guard<std::mutex> lock(r->mu);
    return r->wpos - r->rpos;
}

BN_API int64_t bn_ring_lost(void* h) {
    auto* r = static_cast<AnalysisRing*>(h);
    if (!r) return 0;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->lost;
}

// ---------------------------------------------------------------------------
// Memory policy (reference: internal/mempolicy/arena_linux.go)
// ---------------------------------------------------------------------------

BN_API int bn_set_malloc_arena_max(int arenas) {
#ifdef M_ARENA_MAX
    return mallopt(M_ARENA_MAX, arenas);
#else
    (void)arenas;
    return 0;
#endif
}

// ---------------------------------------------------------------------------
// ALSA capture via dlopen (no libasound at build time).
//
// Mirrors the reference's dlopen/dlsym degradation pattern: if
// libasound.so.2 is absent every entry point reports unavailable and the
// Python layer falls back to file/RTSP sources.
// ---------------------------------------------------------------------------

namespace alsa {

using snd_pcm_t = void;

typedef int (*open_fn)(snd_pcm_t**, const char*, int, int);
typedef int (*set_params_fn)(snd_pcm_t*, int, int, unsigned, unsigned, int,
                             unsigned);
typedef long (*readi_fn)(snd_pcm_t*, void*, unsigned long);
typedef int (*close_fn)(snd_pcm_t*);
typedef int (*recover_fn)(snd_pcm_t*, int, int);

struct Lib {
    void* handle = nullptr;
    open_fn open = nullptr;
    set_params_fn set_params = nullptr;
    readi_fn readi = nullptr;
    close_fn close = nullptr;
    recover_fn recover = nullptr;
    bool ok = false;
};

static Lib& lib() {
    static Lib l;
    static std::once_flag once;
    std::call_once(once, [] {
        l.handle = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle) l.handle = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle) return;
        l.open = reinterpret_cast<open_fn>(dlsym(l.handle, "snd_pcm_open"));
        l.set_params = reinterpret_cast<set_params_fn>(
            dlsym(l.handle, "snd_pcm_set_params"));
        l.readi = reinterpret_cast<readi_fn>(
            dlsym(l.handle, "snd_pcm_readi"));
        l.close = reinterpret_cast<close_fn>(
            dlsym(l.handle, "snd_pcm_close"));
        l.recover = reinterpret_cast<recover_fn>(
            dlsym(l.handle, "snd_pcm_recover"));
        l.ok = l.open && l.set_params && l.readi && l.close;
    });
    return l;
}

}  // namespace alsa

BN_API int bn_alsa_available() { return alsa::lib().ok ? 1 : 0; }

// SND_PCM_STREAM_CAPTURE=1, SND_PCM_FORMAT_S16_LE=2,
// SND_PCM_ACCESS_RW_INTERLEAVED=3
BN_API void* bn_alsa_open(const char* device, unsigned rate,
                          unsigned channels, unsigned latency_us) {
    auto& l = alsa::lib();
    if (!l.ok) return nullptr;
    alsa::snd_pcm_t* pcm = nullptr;
    if (l.open(&pcm, device, /*capture*/ 1, 0) < 0) return nullptr;
    if (l.set_params(pcm, /*S16_LE*/ 2, /*RW_INTERLEAVED*/ 3, channels,
                     rate, /*soft_resample*/ 1, latency_us) < 0) {
        l.close(pcm);
        return nullptr;
    }
    return pcm;
}

// Returns frames read (>0), 0 on recoverable underrun, -1 on fatal error.
BN_API long bn_alsa_read(void* pcm, int16_t* buf, unsigned long frames) {
    auto& l = alsa::lib();
    if (!l.ok || !pcm) return -1;
    long n = l.readi(pcm, buf, frames);
    if (n < 0 && l.recover) {
        if (l.recover(pcm, static_cast<int>(n), 1) == 0) return 0;
        return -1;
    }
    return n;
}

BN_API void bn_alsa_close(void* pcm) {
    auto& l = alsa::lib();
    if (l.ok && pcm) l.close(pcm);
}

// ---------------------------------------------------------------------------
// Device enumeration via snd_device_name_hint (reference: DeviceManager,
// device.go:95 — list capture-capable PCMs so the UI can offer them).
// Emits newline-separated "name\tdescription" pairs into the caller's
// buffer; resolved lazily like the capture symbols so absence degrades.
// ---------------------------------------------------------------------------

namespace alsa {

typedef int (*hint_fn)(int, const char*, void***);
typedef char* (*hint_get_fn)(const void*, const char*);
typedef int (*hint_free_fn)(void**);

struct HintLib {
    hint_fn hint = nullptr;
    hint_get_fn get = nullptr;
    hint_free_fn free_hints = nullptr;
    bool ok = false;
};

static HintLib& hints() {
    static HintLib h;
    static std::once_flag once;
    std::call_once(once, [] {
        auto& l = lib();
        if (!l.handle) return;
        h.hint = reinterpret_cast<hint_fn>(
            dlsym(l.handle, "snd_device_name_hint"));
        h.get = reinterpret_cast<hint_get_fn>(
            dlsym(l.handle, "snd_device_name_get_hint"));
        h.free_hints = reinterpret_cast<hint_free_fn>(
            dlsym(l.handle, "snd_device_name_free_hint"));
        h.ok = h.hint && h.get && h.free_hints;
    });
    return h;
}

}  // namespace alsa

BN_API long bn_alsa_list_devices(char* out, long cap) {
    auto& h = alsa::hints();
    if (!h.ok || !out || cap <= 0) return -1;
    void** list = nullptr;
    if (h.hint(-1, "pcm", &list) < 0 || !list) return -1;
    long written = 0;
    for (void** p = list; *p != nullptr; ++p) {
        char* name = h.get(*p, "NAME");
        char* desc = h.get(*p, "DESC");
        char* ioid = h.get(*p, "IOID");
        // capture-capable: IOID null (both) or "Input"
        bool capture = (ioid == nullptr) || (std::strcmp(ioid, "Input") == 0);
        if (capture && name) {
            // DESC is routinely two lines ("card, device\nusage") — embedded
            // newlines/tabs would corrupt the name\tdesc\n record framing
            std::string d = desc ? desc : "";
            for (char& c : d) {
                if (c == '\n' || c == '\t') c = ' ';
            }
            long need = static_cast<long>(std::strlen(name) + d.size()) + 2;
            if (written + need >= cap) { capture = false; }
            else {
                written += std::snprintf(out + written, cap - written,
                                         "%s\t%s\n", name, d.c_str());
            }
        }
        std::free(name);
        std::free(desc);
        std::free(ioid);
    }
    h.free_hints(list);
    return written;
}

BN_API const char* bn_version() { return "birdnet_host 0.1.0"; }

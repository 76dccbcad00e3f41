// Native lossy audio codecs for clip export and streaming.
//
// Replaces the reference's native encoder stack (SURVEY.md §2.2 "Clip
// encoders": internal/audiocore/opus/encode.go via go-opus→libopus, and the
// FFmpeg mp3 path) with dlopen'd system codecs — the same graceful-absence
// pattern as the ALSA shim and the reference's OpenVINO backend
// (internal/inference/openvino/backend_openvino.go): when the library is
// missing every entry point reports unavailable and the Python layer falls
// back to native FLAC.
//
// C ABI only — consumed from Python via ctypes.
//
// Packet framing: encoders emit a stream of length-prefixed packets
// [u32 LE length][payload]… so Python can mux containers (Ogg Opus) without
// callbacks across the FFI boundary.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <dlfcn.h>

#define BN_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// libopus via dlopen
// ---------------------------------------------------------------------------

// Constants from opus_defines.h (stable public ABI).
static const int OPUS_APPLICATION_AUDIO = 2049;
static const int OPUS_SET_BITRATE_REQUEST = 4002;
static const int OPUS_SET_COMPLEXITY_REQUEST = 4010;
static const int OPUS_GET_LOOKAHEAD_REQUEST = 4027;

typedef void* (*opus_enc_create_fn)(int32_t, int, int, int*);
typedef int (*opus_enc_ctl_fn)(void*, int, ...);
typedef int32_t (*opus_encode_fn)(void*, const int16_t*, int,
                                  unsigned char*, int32_t);
typedef void (*opus_enc_destroy_fn)(void*);
typedef void* (*opus_dec_create_fn)(int32_t, int, int*);
typedef int (*opus_decode_fn)(void*, const unsigned char*, int32_t,
                              int16_t*, int, int);
typedef void (*opus_dec_destroy_fn)(void*);

struct OpusLib {
    void* handle = nullptr;
    bool tried = false;
    opus_enc_create_fn enc_create = nullptr;
    opus_enc_ctl_fn enc_ctl = nullptr;
    opus_encode_fn encode = nullptr;
    opus_enc_destroy_fn enc_destroy = nullptr;
    opus_dec_create_fn dec_create = nullptr;
    opus_decode_fn decode = nullptr;
    opus_dec_destroy_fn dec_destroy = nullptr;
    std::mutex mu;
};

static OpusLib& opuslib() {
    static OpusLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (!l.tried) {
        l.tried = true;
        l.handle = dlopen("libopus.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle) l.handle = dlopen("libopus.so", RTLD_NOW | RTLD_LOCAL);
        if (l.handle) {
            l.enc_create = (opus_enc_create_fn)dlsym(l.handle,
                                                     "opus_encoder_create");
            l.enc_ctl = (opus_enc_ctl_fn)dlsym(l.handle, "opus_encoder_ctl");
            l.encode = (opus_encode_fn)dlsym(l.handle, "opus_encode");
            l.enc_destroy = (opus_enc_destroy_fn)dlsym(l.handle,
                                                       "opus_encoder_destroy");
            l.dec_create = (opus_dec_create_fn)dlsym(l.handle,
                                                     "opus_decoder_create");
            l.decode = (opus_decode_fn)dlsym(l.handle, "opus_decode");
            l.dec_destroy = (opus_dec_destroy_fn)dlsym(l.handle,
                                                       "opus_decoder_destroy");
            if (!l.enc_create || !l.enc_ctl || !l.encode || !l.enc_destroy ||
                !l.dec_create || !l.decode || !l.dec_destroy) {
                dlclose(l.handle);
                l.handle = nullptr;
            }
        }
    }
    return l;
}

BN_API int bn_opus_available() { return opuslib().handle ? 1 : 0; }

// Encode mono/stereo int16 PCM into length-prefixed Opus packets.
//  pcm       : interleaved int16, n_frames per channel
//  rate      : 8000/12000/16000/24000/48000 (Opus-valid rates only)
//  bitrate   : target bits/s (e.g. 64000)
//  out       : caller buffer for [u32 len][packet]... frames
//  preskip   : out — encoder lookahead in samples at `rate`
//  n_packets : out — number of packets written
// Returns bytes written to out, -1 unavailable, -2 bad args, -3 out full,
// -4 encoder error.
BN_API int64_t bn_opus_encode(const int16_t* pcm, int64_t n_frames, int rate,
                              int channels, int bitrate, unsigned char* out,
                              int64_t out_cap, int32_t* n_packets,
                              int32_t* preskip) {
    OpusLib& l = opuslib();
    if (!l.handle) return -1;
    if (!pcm || n_frames <= 0 || (channels != 1 && channels != 2)) return -2;
    if (rate != 8000 && rate != 12000 && rate != 16000 && rate != 24000 &&
        rate != 48000) return -2;
    int err = 0;
    void* enc = l.enc_create(rate, channels, OPUS_APPLICATION_AUDIO, &err);
    if (!enc || err != 0) return -4;
    l.enc_ctl(enc, OPUS_SET_BITRATE_REQUEST, (int32_t)bitrate);
    l.enc_ctl(enc, OPUS_SET_COMPLEXITY_REQUEST, (int32_t)8);
    int32_t look = 0;
    l.enc_ctl(enc, OPUS_GET_LOOKAHEAD_REQUEST, &look);
    if (preskip) *preskip = look;

    const int frame = rate / 50;              // 20 ms frames
    unsigned char pkt[4000];                  // max recommended packet size
    int64_t written = 0;
    int32_t packets = 0;
    // zero-padded tail frame keeps total sample accounting simple: the
    // muxer trims via Ogg granule positions (audiocore/opus/encode.go role)
    std::vector<int16_t> scratch((size_t)frame * channels);
    for (int64_t off = 0; off < n_frames; off += frame) {
        const int16_t* src;
        int64_t have = n_frames - off;
        if (have >= frame) {
            src = pcm + off * channels;
        } else {
            std::memset(scratch.data(), 0, scratch.size() * sizeof(int16_t));
            std::memcpy(scratch.data(), pcm + off * channels,
                        (size_t)have * channels * sizeof(int16_t));
            src = scratch.data();
        }
        int32_t n = l.encode(enc, src, frame, pkt, (int32_t)sizeof(pkt));
        if (n < 0) { l.enc_destroy(enc); return -4; }
        if (written + 4 + n > out_cap) { l.enc_destroy(enc); return -3; }
        out[written + 0] = (unsigned char)(n & 0xff);
        out[written + 1] = (unsigned char)((n >> 8) & 0xff);
        out[written + 2] = (unsigned char)((n >> 16) & 0xff);
        out[written + 3] = (unsigned char)((n >> 24) & 0xff);
        std::memcpy(out + written + 4, pkt, (size_t)n);
        written += 4 + n;
        packets++;
    }
    l.enc_destroy(enc);
    if (n_packets) *n_packets = packets;
    return written;
}

// Decode length-prefixed Opus packets back to interleaved int16 PCM.
// Returns frames (per channel) written, or negative error.
BN_API int64_t bn_opus_decode(const unsigned char* packets,
                              int64_t packets_len, int rate, int channels,
                              int16_t* out, int64_t out_cap_frames) {
    OpusLib& l = opuslib();
    if (!l.handle) return -1;
    if (!packets || (channels != 1 && channels != 2)) return -2;
    int err = 0;
    void* dec = l.dec_create(rate, channels, &err);
    if (!dec || err != 0) return -4;
    const int max_frame = rate * 60 / 1000;   // max 60 ms packets
    int64_t frames = 0;
    int64_t off = 0;
    while (off + 4 <= packets_len) {
        uint32_t n = (uint32_t)packets[off] | ((uint32_t)packets[off + 1] << 8)
            | ((uint32_t)packets[off + 2] << 16)
            | ((uint32_t)packets[off + 3] << 24);
        off += 4;
        if (off + (int64_t)n > packets_len) break;
        if (frames + max_frame > out_cap_frames) { l.dec_destroy(dec); return -3; }
        int got = l.decode(dec, packets + off, (int32_t)n,
                           out + frames * channels, max_frame, 0);
        if (got < 0) { l.dec_destroy(dec); return -4; }
        frames += got;
        off += n;
    }
    l.dec_destroy(dec);
    return frames;
}

// ---------------------------------------------------------------------------
// Streaming Opus encoder: persistent state across chunks so a live HTTP
// stream has no per-chunk lookahead resets (no clicks at chunk joins).
// Partial 20 ms frames carry over inside the handle.
// ---------------------------------------------------------------------------

struct OpusStream {
    void* enc;
    int rate;
    int channels;
    std::vector<int16_t> carry;   // < one frame of samples (interleaved)
};

BN_API void* bn_opus_stream_create(int rate, int channels, int bitrate,
                                   int32_t* preskip) {
    OpusLib& l = opuslib();
    if (!l.handle) return nullptr;
    if ((channels != 1 && channels != 2) ||
        (rate != 8000 && rate != 12000 && rate != 16000 && rate != 24000 &&
         rate != 48000)) return nullptr;
    int err = 0;
    void* enc = l.enc_create(rate, channels, OPUS_APPLICATION_AUDIO, &err);
    if (!enc || err != 0) return nullptr;
    l.enc_ctl(enc, OPUS_SET_BITRATE_REQUEST, (int32_t)bitrate);
    l.enc_ctl(enc, OPUS_SET_COMPLEXITY_REQUEST, (int32_t)6);
    int32_t look = 0;
    l.enc_ctl(enc, OPUS_GET_LOOKAHEAD_REQUEST, &look);
    if (preskip) *preskip = look;
    auto* s = new OpusStream{enc, rate, channels, {}};
    return s;
}

// Feed PCM; emits length-prefixed packets for every complete 20 ms frame.
// Returns bytes written to out (0 when not enough audio yet), or negative
// error like bn_opus_encode.
BN_API int64_t bn_opus_stream_encode(void* handle, const int16_t* pcm,
                                     int64_t n_frames, unsigned char* out,
                                     int64_t out_cap, int32_t* n_packets) {
    OpusLib& l = opuslib();
    auto* s = (OpusStream*)handle;
    if (!s || !l.handle) return -1;
    if (n_frames < 0) return -2;
    const int frame = s->rate / 50;
    s->carry.insert(s->carry.end(), pcm,
                    pcm + (size_t)n_frames * s->channels);
    unsigned char pkt[4000];
    int64_t written = 0;
    int32_t packets = 0;
    size_t off = 0;
    const size_t frame_sz = (size_t)frame * s->channels;
    while (s->carry.size() - off >= frame_sz) {
        // capacity precheck BEFORE encoding: once l.encode runs, the
        // encoder's predictive state has consumed the frame, so bailing
        // out afterwards would either duplicate it (carry kept) or glitch
        // (packet dropped). Unencoded frames stay in carry for next call;
        // callers size out_cap >= 16 KiB so this never fires in practice.
        if (out_cap - written < 4 + (int64_t)sizeof(pkt)) break;
        int32_t n = l.encode(s->enc, s->carry.data() + off, frame, pkt,
                             (int32_t)sizeof(pkt));
        if (n < 0) { s->carry.erase(s->carry.begin(),
                                    s->carry.begin() + (long)off);
                     return -4; }
        out[written + 0] = (unsigned char)(n & 0xff);
        out[written + 1] = (unsigned char)((n >> 8) & 0xff);
        out[written + 2] = (unsigned char)((n >> 16) & 0xff);
        out[written + 3] = (unsigned char)((n >> 24) & 0xff);
        std::memcpy(out + written + 4, pkt, (size_t)n);
        written += 4 + n;
        packets++;
        off += frame_sz;
    }
    s->carry.erase(s->carry.begin(), s->carry.begin() + (long)off);
    if (n_packets) *n_packets = packets;
    return written;
}

BN_API void bn_opus_stream_destroy(void* handle) {
    auto* s = (OpusStream*)handle;
    if (!s) return;
    opuslib().enc_destroy(s->enc);
    delete s;
}

// ---------------------------------------------------------------------------
// libmp3lame via dlopen
// ---------------------------------------------------------------------------

typedef void* (*lame_init_fn)();
typedef int (*lame_set_i_fn)(void*, int);
typedef int (*lame_init_params_fn)(void*);
typedef int (*lame_enc_buf_fn)(void*, const int16_t*, const int16_t*, int,
                               unsigned char*, int);
typedef int (*lame_enc_interleaved_fn)(void*, int16_t*, int, unsigned char*,
                                       int);
typedef int (*lame_flush_fn)(void*, unsigned char*, int);
typedef int (*lame_close_fn)(void*);

struct LameLib {
    void* handle = nullptr;
    bool tried = false;
    lame_init_fn init = nullptr;
    lame_set_i_fn set_in_samplerate = nullptr;
    lame_set_i_fn set_num_channels = nullptr;
    lame_set_i_fn set_brate = nullptr;
    lame_set_i_fn set_quality = nullptr;
    lame_init_params_fn init_params = nullptr;
    lame_enc_buf_fn encode_buffer = nullptr;
    lame_enc_interleaved_fn encode_interleaved = nullptr;
    lame_flush_fn flush = nullptr;
    lame_close_fn close = nullptr;
    std::mutex mu;
};

static LameLib& lamelib() {
    static LameLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (!l.tried) {
        l.tried = true;
        l.handle = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle)
            l.handle = dlopen("libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
        if (l.handle) {
            l.init = (lame_init_fn)dlsym(l.handle, "lame_init");
            l.set_in_samplerate =
                (lame_set_i_fn)dlsym(l.handle, "lame_set_in_samplerate");
            l.set_num_channels =
                (lame_set_i_fn)dlsym(l.handle, "lame_set_num_channels");
            l.set_brate = (lame_set_i_fn)dlsym(l.handle, "lame_set_brate");
            l.set_quality = (lame_set_i_fn)dlsym(l.handle, "lame_set_quality");
            l.init_params =
                (lame_init_params_fn)dlsym(l.handle, "lame_init_params");
            l.encode_buffer =
                (lame_enc_buf_fn)dlsym(l.handle, "lame_encode_buffer");
            l.encode_interleaved = (lame_enc_interleaved_fn)dlsym(
                l.handle, "lame_encode_buffer_interleaved");
            l.flush = (lame_flush_fn)dlsym(l.handle, "lame_encode_flush");
            l.close = (lame_close_fn)dlsym(l.handle, "lame_close");
            if (!l.init || !l.set_in_samplerate || !l.set_num_channels ||
                !l.set_brate || !l.set_quality || !l.init_params ||
                !l.encode_buffer || !l.flush || !l.close) {
                dlclose(l.handle);
                l.handle = nullptr;
            }
        }
    }
    return l;
}

BN_API int bn_mp3_available() { return lamelib().handle ? 1 : 0; }

// Encode int16 PCM to a complete MP3 stream. Returns bytes written,
// -1 unavailable, -2 bad args, -3 out full, -4 encoder error.
BN_API int64_t bn_mp3_encode(const int16_t* pcm, int64_t n_frames, int rate,
                             int channels, int bitrate_kbps,
                             unsigned char* out, int64_t out_cap) {
    LameLib& l = lamelib();
    if (!l.handle) return -1;
    if (!pcm || n_frames <= 0 || (channels != 1 && channels != 2)) return -2;
    void* gfp = l.init();
    if (!gfp) return -4;
    l.set_in_samplerate(gfp, rate);
    l.set_num_channels(gfp, channels);
    l.set_brate(gfp, bitrate_kbps);
    l.set_quality(gfp, 2);
    if (l.init_params(gfp) < 0) { l.close(gfp); return -4; }
    int64_t written = 0;
    const int chunk = 4608;                   // multiple of MP3 granule
    for (int64_t off = 0; off < n_frames; off += chunk) {
        int n = (int)((n_frames - off) < chunk ? (n_frames - off) : chunk);
        int cap = (int)(out_cap - written);
        if (cap <= 0) { l.close(gfp); return -3; }
        int got;
        if (channels == 1) {
            got = l.encode_buffer(gfp, pcm + off, nullptr, n,
                                  out + written, cap);
        } else if (l.encode_interleaved) {
            got = l.encode_interleaved(gfp, (int16_t*)(pcm + off * 2), n,
                                       out + written, cap);
        } else {
            l.close(gfp);
            return -4;
        }
        if (got < 0) { l.close(gfp); return got == -1 ? -3 : -4; }
        written += got;
    }
    int cap = (int)(out_cap - written);
    int got = l.flush(gfp, out + written, cap > 0 ? cap : 0);
    if (got < 0) { l.close(gfp); return -3; }
    written += got;
    l.close(gfp);
    return written;
}

// ---------------------------------------------------------------------------
// AAC-LC via dlopen'd libavcodec (FFmpeg's native aac encoder/decoder).
//
// The reference encodes AAC natively in Go (internal/audiocore/aac/encode.go)
// and muxes AAC HLS (hlsmux/codec_aac.go); stock Safari/Chrome MSE only
// reliably plays AAC audio. Headers provide the stable-within-major-59 ABI
// (struct offsets, AV_CODEC_ID_AAC); symbols are resolved at runtime so a
// host without libavcodec degrades gracefully (bn_aac_available() == 0 and
// the Python layer falls back to FLAC, same contract as Opus/MP3 above).
//
// Streaming handles mirror bn_opus_stream_*: partial 1024-sample AAC frames
// carry over across calls so live HLS segments join without encoder resets.
// ---------------------------------------------------------------------------

#if __has_include(<libavcodec/avcodec.h>)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
#include <libavutil/frame.h>
#include <libavutil/mem.h>
}

struct AvLib {
    void* avc = nullptr;            // libavcodec handle
    void* avu = nullptr;            // libavutil handle
    bool tried = false;
    decltype(&avcodec_find_encoder) find_encoder = nullptr;
    decltype(&avcodec_find_decoder) find_decoder = nullptr;
    decltype(&avcodec_alloc_context3) alloc_context = nullptr;
    decltype(&avcodec_free_context) free_context = nullptr;
    decltype(&avcodec_open2) open2 = nullptr;
    decltype(&avcodec_send_frame) send_frame = nullptr;
    decltype(&avcodec_receive_packet) receive_packet = nullptr;
    decltype(&avcodec_send_packet) send_packet = nullptr;
    decltype(&avcodec_receive_frame) receive_frame = nullptr;
    decltype(&av_packet_alloc) packet_alloc = nullptr;
    decltype(&av_packet_free) packet_free = nullptr;
    decltype(&av_packet_unref) packet_unref = nullptr;
    decltype(&av_frame_alloc) frame_alloc = nullptr;
    decltype(&av_frame_free) frame_free = nullptr;
    decltype(&av_frame_unref) frame_unref = nullptr;
    decltype(&av_frame_get_buffer) frame_get_buffer = nullptr;
    decltype(&av_channel_layout_default) ch_layout_default = nullptr;
    decltype(&av_mallocz) mallocz = nullptr;
    std::mutex mu;
};

static AvLib& avlib() {
    static AvLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (!l.tried) {
        l.tried = true;
        l.avu = dlopen("libavutil.so.57", RTLD_NOW | RTLD_LOCAL);
        if (!l.avu) l.avu = dlopen("libavutil.so", RTLD_NOW | RTLD_LOCAL);
        l.avc = dlopen("libavcodec.so.59", RTLD_NOW | RTLD_LOCAL);
        if (!l.avc) l.avc = dlopen("libavcodec.so", RTLD_NOW | RTLD_LOCAL);
        if (l.avc && l.avu) {
            l.find_encoder = (decltype(l.find_encoder))dlsym(
                l.avc, "avcodec_find_encoder");
            l.find_decoder = (decltype(l.find_decoder))dlsym(
                l.avc, "avcodec_find_decoder");
            l.alloc_context = (decltype(l.alloc_context))dlsym(
                l.avc, "avcodec_alloc_context3");
            l.free_context = (decltype(l.free_context))dlsym(
                l.avc, "avcodec_free_context");
            l.open2 = (decltype(l.open2))dlsym(l.avc, "avcodec_open2");
            l.send_frame = (decltype(l.send_frame))dlsym(
                l.avc, "avcodec_send_frame");
            l.receive_packet = (decltype(l.receive_packet))dlsym(
                l.avc, "avcodec_receive_packet");
            l.send_packet = (decltype(l.send_packet))dlsym(
                l.avc, "avcodec_send_packet");
            l.receive_frame = (decltype(l.receive_frame))dlsym(
                l.avc, "avcodec_receive_frame");
            l.packet_alloc = (decltype(l.packet_alloc))dlsym(
                l.avc, "av_packet_alloc");
            l.packet_free = (decltype(l.packet_free))dlsym(
                l.avc, "av_packet_free");
            l.packet_unref = (decltype(l.packet_unref))dlsym(
                l.avc, "av_packet_unref");
            l.frame_alloc = (decltype(l.frame_alloc))dlsym(
                l.avu, "av_frame_alloc");
            l.frame_free = (decltype(l.frame_free))dlsym(
                l.avu, "av_frame_free");
            l.frame_unref = (decltype(l.frame_unref))dlsym(
                l.avu, "av_frame_unref");
            l.frame_get_buffer = (decltype(l.frame_get_buffer))dlsym(
                l.avu, "av_frame_get_buffer");
            l.ch_layout_default = (decltype(l.ch_layout_default))dlsym(
                l.avu, "av_channel_layout_default");
            l.mallocz = (decltype(l.mallocz))dlsym(l.avu, "av_mallocz");
            // silence Qavg/experimental chatter on the server's stderr
            auto set_level = (void (*)(int))dlsym(l.avu, "av_log_set_level");
            if (set_level) set_level(AV_LOG_ERROR);
            if (!l.mallocz || !l.find_encoder || !l.find_decoder ||
                !l.alloc_context ||
                !l.free_context || !l.open2 || !l.send_frame ||
                !l.receive_packet || !l.send_packet || !l.receive_frame ||
                !l.packet_alloc || !l.packet_free || !l.packet_unref ||
                !l.frame_alloc || !l.frame_free || !l.frame_unref ||
                !l.frame_get_buffer || !l.ch_layout_default) {
                dlclose(l.avc); dlclose(l.avu);
                l.avc = l.avu = nullptr;
            }
        } else {
            if (l.avc) { dlclose(l.avc); l.avc = nullptr; }
            if (l.avu) { dlclose(l.avu); l.avu = nullptr; }
        }
    }
    return l;
}

BN_API int bn_aac_available() {
    AvLib& l = avlib();
    return (l.avc && l.find_encoder(AV_CODEC_ID_AAC)) ? 1 : 0;
}

struct AacStream {
    AVCodecContext* ctx;
    AVFrame* frame;
    AVPacket* pkt;
    int rate;
    int channels;
    std::vector<int16_t> carry;     // < one 1024-sample frame, interleaved
    // a packet that did not fit the caller's out buffer is PARKED here
    // (never destroyed — once pulled from the encoder it cannot be
    // re-received) and emitted first on the next drain
    std::vector<unsigned char> pending;
    bool flushed = false;
};

static bool emit_packet(const unsigned char* data, int n,
                        unsigned char* out, int64_t out_cap,
                        int64_t& written, int32_t* packets) {
    if (written + 4 + n > out_cap) return false;
    out[written + 0] = (unsigned char)(n & 0xff);
    out[written + 1] = (unsigned char)((n >> 8) & 0xff);
    out[written + 2] = (unsigned char)((n >> 16) & 0xff);
    out[written + 3] = (unsigned char)((n >> 24) & 0xff);
    std::memcpy(out + written + 4, data, (size_t)n);
    written += 4 + n;
    if (packets) (*packets)++;
    return true;
}

// Drain every pending packet from the encoder into the length-prefixed
// out buffer. A packet that doesn't fit is parked on the stream (NOT
// destroyed) and the bytes already written are returned — no audio is
// ever lost to an undersized buffer. Returns bytes appended or -4.
static int64_t aac_drain(AacStream* s, unsigned char* out, int64_t out_cap,
                         int64_t written, int32_t* packets) {
    AvLib& l = avlib();
    if (!s->pending.empty()) {
        if (!emit_packet(s->pending.data(), (int)s->pending.size(), out,
                         out_cap, written, packets)) {
            return written;
        }
        s->pending.clear();
    }
    for (;;) {
        int r = l.receive_packet(s->ctx, s->pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return written;
        if (r < 0) return -4;
        int n = s->pkt->size;
        if (!emit_packet(s->pkt->data, n, out, out_cap, written, packets)) {
            s->pending.assign(s->pkt->data, s->pkt->data + n);
            l.packet_unref(s->pkt);
            return written;
        }
        l.packet_unref(s->pkt);
    }
}

// Create a streaming AAC-LC encoder. asc_out receives the
// AudioSpecificConfig (the esds/mp4a DecoderSpecificInfo — 2 bytes for
// LC at common rates); returns the handle or null.
BN_API void* bn_aac_stream_create(int rate, int channels, int bitrate,
                                  unsigned char* asc_out, int32_t asc_cap,
                                  int32_t* asc_len) {
    AvLib& l = avlib();
    if (!l.avc || channels < 1 || channels > 2 || rate <= 0) return nullptr;
    const AVCodec* codec = l.find_encoder(AV_CODEC_ID_AAC);
    if (!codec) return nullptr;
    AVCodecContext* ctx = l.alloc_context(codec);
    if (!ctx) return nullptr;
    ctx->sample_rate = rate;
    ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
    ctx->bit_rate = bitrate;
    ctx->profile = FF_PROFILE_AAC_LOW;
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;   // extradata = ASC
    l.ch_layout_default(&ctx->ch_layout, channels);
    if (l.open2(ctx, codec, nullptr) < 0) {
        l.free_context(&ctx);
        return nullptr;
    }
    if (asc_len) {
        int32_t n = (int32_t)ctx->extradata_size;
        if (asc_out && n > 0 && n <= asc_cap)
            std::memcpy(asc_out, ctx->extradata, (size_t)n);
        *asc_len = n;
    }
    AVFrame* frame = l.frame_alloc();
    AVPacket* pkt = l.packet_alloc();
    if (!frame || !pkt) {
        if (frame) l.frame_free(&frame);
        if (pkt) l.packet_free(&pkt);
        l.free_context(&ctx);
        return nullptr;
    }
    return new AacStream{ctx, frame, pkt, rate, channels, {}, {}, false};
}

// Feed interleaved int16 PCM; writes length-prefixed raw AAC packets
// (1024 samples per packet). Returns bytes written or negative error
// (-1 bad handle, -3 out full, -4 encoder error).
BN_API int64_t bn_aac_stream_encode(void* handle, const int16_t* pcm,
                                    int64_t n_frames, unsigned char* out,
                                    int64_t out_cap, int32_t* n_packets) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s || !l.avc || s->flushed) return -1;
    if (n_frames < 0) return -2;
    if (n_packets) *n_packets = 0;
    const int fsz = s->ctx->frame_size > 0 ? s->ctx->frame_size : 1024;
    if (pcm && n_frames > 0)
        s->carry.insert(s->carry.end(), pcm,
                        pcm + (size_t)n_frames * s->channels);
    int64_t written = 0;
    size_t off = 0;
    const size_t frame_sz = (size_t)fsz * s->channels;
    while (s->carry.size() - off >= frame_sz) {
        s->frame->nb_samples = fsz;
        s->frame->format = AV_SAMPLE_FMT_FLTP;
        l.ch_layout_default(&s->frame->ch_layout, s->channels);
        if (l.frame_get_buffer(s->frame, 0) < 0) return -4;
        const int16_t* src = s->carry.data() + off;
        for (int c = 0; c < s->channels; ++c) {
            float* dst = (float*)s->frame->data[c];
            for (int i = 0; i < fsz; ++i)
                dst[i] = src[(size_t)i * s->channels + c] * (1.0f / 32768.0f);
        }
        int r = l.send_frame(s->ctx, s->frame);
        l.frame_unref(s->frame);
        if (r < 0) return -4;
        off += frame_sz;
        written = aac_drain(s, out, out_cap, written, n_packets);
        if (written < 0) break;
    }
    s->carry.erase(s->carry.begin(), s->carry.begin() + (long)off);
    return written;
}

// Pad the final partial frame with silence, flush the encoder, and emit
// the remaining packets. The stream is unusable afterwards.
BN_API int64_t bn_aac_stream_flush(void* handle, unsigned char* out,
                                   int64_t out_cap, int32_t* n_packets) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s || !l.avc) return -1;
    if (s->flushed) {
        // re-entry drains only a parked packet (encoder is at EOF)
        if (n_packets) *n_packets = 0;
        return aac_drain(s, out, out_cap, 0, n_packets);
    }
    if (n_packets) *n_packets = 0;
    int64_t written = 0;
    if (!s->carry.empty()) {
        const int fsz = s->ctx->frame_size > 0 ? s->ctx->frame_size : 1024;
        const size_t frame_sz = (size_t)fsz * s->channels;
        s->carry.resize(frame_sz, 0);
        written = bn_aac_stream_encode(handle, nullptr, 0, out, out_cap,
                                       n_packets);
        if (written < 0) return written;
    }
    s->flushed = true;
    if (l.send_frame(s->ctx, nullptr) < 0) return -4;
    int32_t extra = 0;
    int64_t total = aac_drain(s, out, out_cap, written, &extra);
    if (n_packets && total >= 0) *n_packets += extra;
    return total;
}

// Encoder priming delay in samples (MP4 edit lists trim it; ~1024-2048
// for the native FFmpeg AAC encoder). Valid after create.
BN_API int32_t bn_aac_stream_delay(void* handle) {
    auto* s = (AacStream*)handle;
    if (!s) return 0;
    return (int32_t)s->ctx->initial_padding;
}

BN_API void bn_aac_stream_destroy(void* handle) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s) return;
    l.frame_free(&s->frame);
    l.packet_free(&s->pkt);
    l.free_context(&s->ctx);
    delete s;
}

// Decode length-prefixed raw AAC packets (with the stream's ASC as
// extradata) back to interleaved int16 PCM — the e2e oracle for encoder
// and mux tests, mirroring bn_opus_decode. Returns frames per channel
// written, or negative error.
BN_API int64_t bn_aac_decode(const unsigned char* packets,
                             int64_t packets_len, const unsigned char* asc,
                             int32_t asc_len, int rate, int channels,
                             int16_t* out, int64_t out_cap_frames) {
    AvLib& l = avlib();
    if (!l.avc) return -1;
    if (!packets || channels < 1 || channels > 2) return -2;
    const AVCodec* codec = l.find_decoder(AV_CODEC_ID_AAC);
    if (!codec) return -1;
    AVCodecContext* ctx = l.alloc_context(codec);
    if (!ctx) return -4;
    ctx->sample_rate = rate;
    l.ch_layout_default(&ctx->ch_layout, channels);
    if (asc && asc_len > 0) {
        // avcodec_free_context av_free()s extradata — it must come from
        // av_mallocz (with AV_INPUT_BUFFER_PADDING_SIZE padding)
        ctx->extradata = (uint8_t*)l.mallocz((size_t)asc_len + 64);
        if (!ctx->extradata) { l.free_context(&ctx); return -4; }
        std::memcpy(ctx->extradata, asc, (size_t)asc_len);
        ctx->extradata_size = asc_len;
    }
    if (l.open2(ctx, codec, nullptr) < 0) { l.free_context(&ctx); return -4; }
    AVFrame* frame = l.frame_alloc();
    AVPacket* pkt = l.packet_alloc();
    int64_t frames = 0;
    int64_t off = 0;
    bool fail = false;
    // avcodec_send_packet requires AV_INPUT_BUFFER_PADDING_SIZE zeroed
    // bytes past the payload (optimized bitstream readers over-read);
    // pointing pkt->data at the caller's buffer would heap-over-read on
    // a packet whose last codeword ends at the boundary
    std::vector<uint8_t> padded;
    while (off + 4 <= packets_len && !fail) {
        uint32_t n = (uint32_t)packets[off] | ((uint32_t)packets[off + 1] << 8)
            | ((uint32_t)packets[off + 2] << 16)
            | ((uint32_t)packets[off + 3] << 24);
        off += 4;
        if (off + (int64_t)n > packets_len) break;
        padded.assign(packets + off, packets + off + n);
        padded.resize(n + AV_INPUT_BUFFER_PADDING_SIZE, 0);
        pkt->data = padded.data();
        pkt->size = (int)n;
        off += n;
        if (l.send_packet(ctx, pkt) < 0) { fail = true; break; }
        for (;;) {
            int r = l.receive_frame(ctx, frame);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) { fail = true; break; }
            int got = frame->nb_samples;
            if (frames + got > out_cap_frames) {
                l.frame_unref(frame);
                fail = true;
                break;
            }
            for (int c = 0; c < channels; ++c) {
                const float* srcf = (const float*)frame->data[c];
                for (int i = 0; i < got; ++i) {
                    float v = srcf[i];
                    if (v > 0.999969f) v = 0.999969f;
                    if (v < -1.0f) v = -1.0f;
                    out[(frames + i) * channels + c] =
                        (int16_t)(v * 32768.0f);
                }
            }
            frames += got;
            l.frame_unref(frame);
        }
    }
    // drain decoder
    if (!fail && l.send_packet(ctx, nullptr) >= 0) {
        for (;;) {
            int r = l.receive_frame(ctx, frame);
            if (r < 0) break;
            int got = frame->nb_samples;
            if (frames + got > out_cap_frames) { l.frame_unref(frame); break; }
            for (int c = 0; c < channels; ++c) {
                const float* srcf = (const float*)frame->data[c];
                for (int i = 0; i < got; ++i) {
                    float v = srcf[i];
                    if (v > 0.999969f) v = 0.999969f;
                    if (v < -1.0f) v = -1.0f;
                    out[(frames + i) * channels + c] =
                        (int16_t)(v * 32768.0f);
                }
            }
            frames += got;
            l.frame_unref(frame);
        }
    }
    l.frame_free(&frame);
    l.packet_free(&pkt);
    l.free_context(&ctx);
    return fail && frames == 0 ? -4 : frames;
}

// Persistent AAC decoder handle for RTP streams (RFC 3640 AUs arrive one
// packet at a time; AAC-LC's MDCT overlap-add means frames must decode
// through ONE decoder instance or every frame boundary clicks).
struct AacDecoder {
    AVCodecContext* ctx;
    AVFrame* frame;
    AVPacket* pkt;
    int channels;
    std::vector<uint8_t> padded;    // AV_INPUT_BUFFER_PADDING_SIZE scratch
};

BN_API void* bn_aac_decoder_create(const unsigned char* asc,
                                   int32_t asc_len, int rate,
                                   int channels) {
    AvLib& l = avlib();
    if (!l.avc || channels < 1 || channels > 2) return nullptr;
    const AVCodec* codec = l.find_decoder(AV_CODEC_ID_AAC);
    if (!codec) return nullptr;
    AVCodecContext* ctx = l.alloc_context(codec);
    if (!ctx) return nullptr;
    ctx->sample_rate = rate;
    l.ch_layout_default(&ctx->ch_layout, channels);
    if (asc && asc_len > 0) {
        ctx->extradata = (uint8_t*)l.mallocz((size_t)asc_len + 64);
        if (!ctx->extradata) { l.free_context(&ctx); return nullptr; }
        std::memcpy(ctx->extradata, asc, (size_t)asc_len);
        ctx->extradata_size = asc_len;
    }
    if (l.open2(ctx, codec, nullptr) < 0) {
        l.free_context(&ctx);
        return nullptr;
    }
    AVFrame* frame = l.frame_alloc();
    AVPacket* pkt = l.packet_alloc();
    if (!frame || !pkt) {
        if (frame) l.frame_free(&frame);
        if (pkt) l.packet_free(&pkt);
        l.free_context(&ctx);
        return nullptr;
    }
    return new AacDecoder{ctx, frame, pkt, channels, {}};
}

// Decode ONE access unit; returns frames per channel written to out
// (interleaved int16), 0 when the decoder buffered it, negative error.
BN_API int64_t bn_aac_decoder_decode(void* handle, const unsigned char* au,
                                     int64_t au_len, int16_t* out,
                                     int64_t out_cap_frames) {
    AvLib& l = avlib();
    auto* d = (AacDecoder*)handle;
    if (!d || !l.avc || !au || au_len <= 0) return -1;
    // copy into the padded scratch — see bn_aac_decode (RTP AUs are
    // network-controlled; over-read past the payload is the failure)
    d->padded.assign(au, au + au_len);
    d->padded.resize((size_t)au_len + AV_INPUT_BUFFER_PADDING_SIZE, 0);
    d->pkt->data = d->padded.data();
    d->pkt->size = (int)au_len;
    if (l.send_packet(d->ctx, d->pkt) < 0) return -4;
    int64_t frames = 0;
    for (;;) {
        int r = l.receive_frame(d->ctx, d->frame);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) return -4;
        int got = d->frame->nb_samples;
        if (frames + got > out_cap_frames) {
            l.frame_unref(d->frame);
            return -3;
        }
        for (int c = 0; c < d->channels; ++c) {
            const float* srcf = (const float*)d->frame->data[c];
            for (int i = 0; i < got; ++i) {
                float v = srcf[i];
                if (v > 0.999969f) v = 0.999969f;
                if (v < -1.0f) v = -1.0f;
                out[(frames + i) * d->channels + c] =
                    (int16_t)(v * 32768.0f);
            }
        }
        frames += got;
        l.frame_unref(d->frame);
    }
    return frames;
}

BN_API void bn_aac_decoder_destroy(void* handle) {
    AvLib& l = avlib();
    auto* d = (AacDecoder*)handle;
    if (!d) return;
    l.frame_free(&d->frame);
    l.packet_free(&d->pkt);
    l.free_context(&d->ctx);
    delete d;
}

#else  // built without FFmpeg's headers: AAC reports unavailable and the
       // Python layer falls back to FLAC, as on a host without libavcodec

BN_API int bn_aac_available() { return 0; }
BN_API void* bn_aac_stream_create(int, int, int, unsigned char*, int32_t,
                                  int32_t*) { return nullptr; }
BN_API int64_t bn_aac_stream_encode(void*, const int16_t*, int64_t,
                                    unsigned char*, int64_t, int32_t*) {
    return -1;
}
BN_API int64_t bn_aac_stream_flush(void*, unsigned char*, int64_t,
                                   int32_t*) { return -1; }
BN_API int32_t bn_aac_stream_delay(void*) { return 0; }
BN_API void bn_aac_stream_destroy(void*) {}
BN_API int64_t bn_aac_decode(const unsigned char*, int64_t,
                             const unsigned char*, int32_t, int, int,
                             int16_t*, int64_t) { return -1; }
BN_API void* bn_aac_decoder_create(const unsigned char*, int32_t, int,
                                   int) { return nullptr; }
BN_API int64_t bn_aac_decoder_decode(void*, const unsigned char*, int64_t,
                                     int16_t*, int64_t) { return -1; }
BN_API void bn_aac_decoder_destroy(void*) {}

#endif

"""Realtime core: streaming resampler continuity, engine fan-out, the
batched device loop, results queue, and datastore."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from birdnet_go_tpu.audio.engine import AudioEngine
from birdnet_go_tpu.audio.resampler import StreamingResampler
from birdnet_go_tpu.audio.source import AudioSource, SourceType
from birdnet_go_tpu.datastore.sqlite import Datastore
from birdnet_go_tpu.models.registry import ModelSpec
from birdnet_go_tpu.scheduler.loop import DeviceLoop, ModelBatcher
from birdnet_go_tpu.scheduler.results_queue import ResultsQueue


# -- streaming resampler ---------------------------------------------------------

def test_streaming_matches_batch_resample():
    from birdnet_go_tpu.ops.resample import ResampleConfig, polyphase_resample

    rng = np.random.default_rng(0)
    x = rng.standard_normal(48000).astype(np.float32) * 0.4
    ref = np.asarray(polyphase_resample(jnp.asarray(x),
                                        ResampleConfig(48000, 32000)))
    rs = StreamingResampler(48000, 32000)
    outs = []
    pos = 0
    # deliberately ragged chunk sizes
    for n in (1000, 37, 4096, 12345, 1, 9999, 48000):
        chunk = x[pos:pos + n]
        pos += len(chunk)
        outs.append(rs.process(chunk))
        if pos >= len(x):
            break
    outs.append(rs.flush())
    y = np.concatenate(outs)
    n = min(len(y), len(ref))
    assert n >= len(ref) - 2
    np.testing.assert_allclose(y[:n], ref[:n], atol=5e-4)


def test_streaming_identity_passthrough():
    rs = StreamingResampler(48000, 48000)
    x = np.ones(100, np.float32)
    np.testing.assert_array_equal(rs.process(x), x)


def test_streaming_upsample_length():
    rs = StreamingResampler(32000, 48000)
    total_out = 0
    for _ in range(10):
        total_out += len(rs.process(np.zeros(3200, np.float32)))
    total_out += len(rs.flush())
    assert abs(total_out - 48000) <= 2


# -- engine fan-out ----------------------------------------------------------------

SPEC_A = ModelSpec(model_id="A48", display_name="A", sample_rate=48000,
                   clip_seconds=3.0, num_species=5)
SPEC_B = ModelSpec(model_id="B32", display_name="B", sample_rate=32000,
                   clip_seconds=5.0, num_species=5)
SPEC_BAT = ModelSpec(model_id="BatX", display_name="Bat", sample_rate=48000,
                     clip_seconds=3.0, num_species=5, raw_sample_rate=256000)


def _src(sid="s1", rate=48000):
    return AudioSource(source_id=sid, source_type=SourceType.FILE,
                       display_name=sid, sample_rate=rate)


def test_engine_windows_at_default_overlap():
    eng = AudioEngine([SPEC_A])
    eng.add_source(_src())
    # 3 s clip, 50% overlap → first window after 1.5 s fresh (zero prefix),
    # then one per 1.5 s
    eng.ingest("s1", np.ones(72000, np.int16), timestamp=100.0)
    ready = eng.collect_ready()
    assert len(ready) == 1
    model_id, w, sid, start, rate = ready[0]
    assert model_id == "A48" and sid == "s1"
    assert len(w) == 144000
    assert (w[:72000] == 0).all() and (w[72000:] == 1).all()
    assert start == pytest.approx(100.0 - 3.0)
    # nothing new until another 1.5 s arrives
    assert eng.collect_ready() == []
    eng.ingest("s1", np.full(72000, 2, np.int16), timestamp=101.5)
    ready = eng.collect_ready()
    assert len(ready) == 1
    w = ready[0][1]
    assert (w[:72000] == 1).all() and (w[72000:] == 2).all()


def test_engine_multimodel_resample_fanout():
    eng = AudioEngine([SPEC_A, SPEC_B])
    eng.add_source(_src())
    # 10 s of audio at 48 kHz: A (3s/1.5s hop) → windows; B needs 32 kHz
    # resample and 5 s clips (2.5 s hop). Push 0.1 s extra to cover the
    # streaming resampler's causal filter latency (~1 ms withheld).
    for i in range(10):
        eng.ingest("s1", np.ones(48000, np.int16))
    eng.ingest("s1", np.ones(4800, np.int16))
    ready = eng.collect_ready()
    by_model = {}
    for model_id, w, sid, start, rate in ready:
        by_model.setdefault(model_id, []).append(w)
    # A: fresh windows every 1.5 s → floor(10/1.5) = 6
    assert len(by_model["A48"]) == 6
    # B: 10 s → 32000×10 samples → hop 2.5 s → 4 windows
    assert len(by_model["B32"]) == 4
    assert all(len(w) == 160000 for w in by_model["B32"])


def test_engine_bat_raw_rate_no_resample():
    eng = AudioEngine([SPEC_BAT])
    eng.add_source(_src(rate=256000))
    # 256 kHz source feeds the bat model unresampled: window = 144000 raw
    # samples ≈ 0.5625 s of wall audio. 144000 raw samples = 2× the 72000
    # fresh-read size → two windows (first with zero prefix).
    eng.ingest("s1", np.ones(144000, np.int16))
    ready = eng.collect_ready()
    assert len(ready) == 2
    assert all(len(r[1]) == 144000 for r in ready)
    assert (ready[0][1][:72000] == 0).all()


def test_engine_backlog_windows_get_distinct_starts():
    # ADVICE r1: windows drained in one tick must not share a start time.
    eng = AudioEngine([SPEC_A])
    eng.add_source(_src())
    eng.ingest("s1", np.ones(288000, np.int16), timestamp=200.0)  # 6 s burst
    ready = eng.collect_ready()
    assert len(ready) == 4
    starts = [r[3] for r in ready]
    # Each window steps back by the 1.5 s hop; the newest ends at the
    # write head (start = 200 − 3 s window).
    assert starts == pytest.approx([192.5, 194.0, 195.5, 197.0])


def test_engine_bat_raw_rate_wall_clock_starts():
    # 256 kHz passthrough: 144000 raw samples ≈ 0.5625 s wall clock, so the
    # window span must use the SOURCE rate, not the model's 48 kHz.
    eng = AudioEngine([SPEC_BAT])
    eng.add_source(_src(rate=256000))
    eng.ingest("s1", np.ones(144000, np.int16), timestamp=50.0)
    ready = eng.collect_ready()
    assert len(ready) == 2
    hop = 72000 / 256000.0
    span = 144000 / 256000.0
    assert ready[0][3] == pytest.approx(50.0 - hop - span)
    assert ready[1][3] == pytest.approx(50.0 - span)


def test_engine_add_remove_model_rewires_existing_streams():
    # ADVICE r1: a model loaded at runtime must tap already-added sources.
    eng = AudioEngine([SPEC_A])
    eng.add_source(_src())
    eng.add_model(SPEC_B)
    for _ in range(6):
        eng.ingest("s1", np.ones(48000, np.int16))
    models = {r[0] for r in eng.collect_ready()}
    assert models == {"A48", "B32"}
    eng.add_model(SPEC_B)            # duplicate add is a no-op
    assert sum(1 for s in eng.specs if s.model_id == "B32") == 1
    eng.remove_model("B32")
    for _ in range(6):
        eng.ingest("s1", np.ones(48000, np.int16))
    assert all(r[0] != "B32" for r in eng.collect_ready())


def test_engine_stream_health():
    eng = AudioEngine([SPEC_A])
    eng.add_source(_src())
    eng.ingest("s1", np.zeros(4800, np.int16))
    h = eng.stream_health()
    assert "s1" in h
    assert h["s1"]["capture_seconds_buffered"] == pytest.approx(0.1)


# -- batched device loop --------------------------------------------------------------

class _TinyClassifier:
    """Classifier double for scheduler tests (tiny real JAX model)."""

    def __init__(self):
        from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
        from birdnet_go_tpu.models.efficientnet import (
            BlockSpec,
            EfficientNetConfig,
        )
        from birdnet_go_tpu.ops.melspec import MelConfig

        m = BirdNETv24(num_species=7,
                       mel=MelConfig(sample_rate=48000, n_fft=256, hop=8192,
                                     n_mels=16),
                       compute_dtype=jnp.float32)
        m.net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                                   embedding_dim=16, num_classes=7)
        self.model = m
        self.params = m.init(jax.random.PRNGKey(0))
        self._range_mask = None


def test_model_batcher_dispatch_and_harvest():
    clf = _TinyClassifier()
    results = []
    b = ModelBatcher(clf, max_batch=4, top_k=3,
                     on_result=lambda w, vals, idx: results.append(
                         (w.source_id, w.start_time, vals, idx)))
    pcm = np.zeros(144000, np.int16)
    assert b.offer(pcm, "s1", 10.0)
    assert b.offer(pcm, "s2", 11.0)
    assert b.dispatch() == 2
    assert results == []                 # still in flight
    b.harvest()
    assert len(results) == 2
    assert results[0][0] == "s1" and results[1][1] == 11.0
    assert results[0][2].shape == (3,)
    assert b.stats.windows_processed == 2
    assert b.stats.last_batch_fill == 0.5


def test_model_batcher_bat_cv_computed_on_device():
    """Raw-rate (bat) batchers compute the ultrasonic CV inside the jitted
    step; windows come back annotated so the processor can gate them."""
    import dataclasses as dc

    clf = _TinyClassifier()
    clf.model.spec = dc.replace(clf.model.spec, raw_sample_rate=256000)
    results = []
    b = ModelBatcher(clf, max_batch=2, top_k=2,
                     on_result=lambda w, v, i: results.append(w))
    rng = np.random.default_rng(3)
    steady = (rng.standard_normal(144000) * 3000).astype(np.int16)
    pulsed = np.zeros(144000, np.int16)
    t = np.arange(2000)
    for k in range(5):                 # 5 short 40 kHz chirps
        s0 = k * 28000
        pulsed[s0:s0 + 2000] = (8000 * np.sin(
            2 * np.pi * 40000 * t / 256000)).astype(np.int16)
    b.offer(steady, "s", 0.0, 256000)
    b.offer(pulsed, "s", 1.0, 256000)
    b.dispatch()
    b.harvest()
    cv_steady, cv_pulsed = (w.ultrasonic_cv for w in results)
    assert cv_steady is not None and cv_pulsed is not None
    assert cv_steady < 0.15 < cv_pulsed    # default threshold separates them
    # ordinary model: no CV annotation
    clf2 = _TinyClassifier()
    out2 = []
    b2 = ModelBatcher(clf2, max_batch=1, top_k=2,
                      on_result=lambda w, v, i: out2.append(w))
    b2.offer(steady, "s", 0.0)
    b2.dispatch()
    b2.harvest()
    assert out2[0].ultrasonic_cv is None


def test_save_audio_fallback_to_window_pcm(tmp_path):
    """Clip export falls back to the detection window's queued PCM when the
    CaptureBuffer has lost the span (reference keeps the PCM copy for
    exactly this — process.go:388-396)."""
    from birdnet_go_tpu.analysis.actions import SaveAudioAction
    from birdnet_go_tpu.audio.buffers import CaptureBuffer
    from birdnet_go_tpu.audio.wav import read_wav

    cb = CaptureBuffer(48000, capacity_seconds=2.0)
    # ring contains only recent audio; the requested span predates it
    import time as _t

    now = _t.time()
    cb.write(np.ones(48000, np.int16), timestamp=now - 1)
    fb = (np.sin(np.arange(4800) / 10.0) * 20000).astype(np.int16)
    out = tmp_path / "clip.wav"
    SaveAudioAction(capture_buffer=cb, start_time=now - 500,
                    end_time=now - 488, out_path=out, sample_rate=48000,
                    fallback_pcm=fb, fallback_rate=256000).execute()
    x, info = read_wav(out)
    assert info.sample_rate == 256000          # written at the window's rate
    assert len(x) == 4800 and np.abs(x).max() > 0.1


def test_save_audio_applies_static_gain_and_normalization(tmp_path):
    """One loudness gain is resolved per clip before encoding: the static
    export gain_db, or — when normalization is enabled — the measured
    EBU R128 gain replacing it (reference: actions_database.go:854-880
    encodeClip; WAV used to skip gain there, now every format applies
    it)."""
    from birdnet_go_tpu.analysis.actions import SaveAudioAction
    from birdnet_go_tpu.audio.audionorm import measure_lufs
    from birdnet_go_tpu.audio.buffers import CaptureBuffer
    from birdnet_go_tpu.audio.wav import read_wav
    import time as _t

    rate = 48000
    tone = (np.sin(2 * np.pi * 997.0 * np.arange(rate * 2) / rate)
            * 0.02 * 32767).astype(np.int16)       # quiet: ~-37 LUFS
    now = _t.time()

    def saved(**kw):
        cb = CaptureBuffer(rate, capacity_seconds=4.0)
        cb.write(tone, timestamp=now - 2)
        out = tmp_path / f"clip{len(list(tmp_path.iterdir()))}.wav"
        SaveAudioAction(capture_buffer=cb, start_time=now - 2,
                        end_time=now - 0.5, out_path=out,
                        sample_rate=rate, **kw).execute()
        x, info = read_wav(out)
        return x, info

    base, _ = saved()
    gained, _ = saved(gain_db=6.0)
    assert np.abs(gained).max() == pytest.approx(
        min(np.abs(base).max() * 10 ** (6 / 20), 1.0), rel=0.01)

    normed, _ = saved(normalization={"enabled": True, "target_lufs": -23.0,
                                     "true_peak_db": -2.0})
    assert measure_lufs(normed, rate) == pytest.approx(-23.0, abs=1.0)
    # normalization replaces (not stacks on) the static gain
    normed2, _ = saved(gain_db=12.0,
                       normalization={"enabled": True,
                                      "target_lufs": -23.0,
                                      "true_peak_db": -2.0})
    assert np.abs(np.abs(normed2).max() - np.abs(normed).max()) < 0.01


def test_model_batcher_overflow_defers():
    clf = _TinyClassifier()
    b = ModelBatcher(clf, max_batch=2, top_k=2)
    pcm = np.zeros(144000, np.int16)
    assert b.offer(pcm, "a", 0.0)
    assert b.offer(pcm, "b", 0.0)
    assert not b.offer(pcm, "c", 0.0)
    assert b.stats.windows_deferred == 1


def test_device_loop_end_to_end_tick():
    clf = _TinyClassifier()
    eng = AudioEngine([ModelSpec(model_id="BirdNET_V2.4", display_name="t",
                                 sample_rate=48000, clip_seconds=3.0,
                                 num_species=7)])
    eng.add_source(_src())
    results = []
    b = ModelBatcher(clf, max_batch=4, top_k=3,
                     on_result=lambda w, v, i: results.append(w))
    loop = DeviceLoop(tick_seconds=0.01)
    loop.add_batcher(b)
    loop.add_provider(eng.collect_ready)
    eng.ingest("s1", np.ones(144000, np.int16))   # 3 s → 1 full + partial
    n = loop.run_tick()
    assert n == 2                                  # 2 windows ready (1.5 s hop)
    loop.run_tick()                                # harvests previous
    loop.drain()
    assert len(results) == 2


def test_device_loop_failure_breaker(monkeypatch):
    """An unreachable device fails every 10 Hz tick: the loop must stay
    alive, thin its logging, tag ONE error per outage at 30 consecutive
    failures, surface the count at /system/scheduler, and reset on
    recovery."""
    import birdnet_go_tpu.utils.errors as errors_mod

    loop = DeviceLoop(tick_seconds=0.0001)
    calls = {"n": 0}

    def failing_tick():
        calls["n"] += 1
        if calls["n"] <= 75:
            raise RuntimeError("device unreachable")
        loop._stop.set()                   # recover, then stop the loop
        return 0

    monkeypatch.setattr(loop, "run_tick", failing_tick)
    tagged = []
    monkeypatch.setattr(
        errors_mod, "from_exception",
        lambda e, comp, cat=None: tagged.append(comp))

    loop._stop.clear()
    import threading

    t = threading.Thread(target=loop._run, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert tagged == ["scheduler"]         # once per outage, at tick 30
    assert loop.consecutive_tick_failures == 0   # reset on recovery
    assert "consecutive_tick_failures" in loop.capacity_info()


class _ProbeBatcher:
    """HostBatcher with a controllable readiness probe (handles are
    plain dicts; _ready reads their flag)."""

    def __new__(cls):
        from birdnet_go_tpu.scheduler.loop import HostBatcher

        class _B(HostBatcher):
            def __init__(self, spec):
                self._init_host(spec, max_batch=2, top_k=1,
                                on_result=None, pipeline_depth=4)

            def _launch(self, staged, n):
                return {"ready": False, "n": n}

            def _ready(self, handle):
                return handle["ready"]

            def _collect(self, handle, meta):
                handle["collected"] = True
                n = len(meta)
                return (np.zeros((n, 1), np.float32),
                        np.zeros((n, 1), np.int32), None)

        return _B(ModelSpec(model_id="m", display_name="m",
                            sample_rate=48000, clip_seconds=3.0,
                            num_species=1))


def test_harvest_ready_is_nonblocking_and_ordered():
    """harvest_ready() fans out exactly the completed in-flight batches,
    oldest-first, and never touches an unfinished one — the
    end-to-end-latency lever (a batch must not wait for the pipeline to
    refill to depth before its results move)."""
    b = _ProbeBatcher()
    done = []
    b.on_batch = lambda meta, v, i, cv: done.append(len(meta))
    pcm = np.zeros(144000, np.int16)
    handles = []
    for k in range(3):
        b.offer(pcm, f"s{k}", float(k))
        b.dispatch()
        handles.append(b._inflight[-1][0])
    assert b.harvest_ready() == 0 and done == []     # nothing finished
    handles[0]["ready"] = True
    handles[2]["ready"] = True                       # out of order
    assert b.harvest_ready() == 1                    # only the oldest —
    assert done == [1]                               # #1 still blocks #2
    handles[1]["ready"] = True
    assert b.harvest_ready() == 2
    assert done == [1, 1, 1] and b.inflight_depth == 0


def test_model_batcher_ready_probe_real_device():
    """ModelBatcher._ready uses jax.Array.is_ready(): eventually True
    after dispatch (CPU backend), and a finished batch is harvested by
    harvest_ready() without blocking."""
    clf = _TinyClassifier()
    out = []
    b = ModelBatcher(clf, max_batch=2, top_k=2,
                     on_result=lambda w, v, i: out.append(w))
    b.offer(np.zeros(144000, np.int16), "s", 0.0)
    b.dispatch()
    deadline = time.monotonic() + 30
    while b.inflight_depth and time.monotonic() < deadline:
        b.harvest_ready()
        time.sleep(0.005)
    assert len(out) == 1                 # probe turned True, fan-out ran
    b.offer(np.zeros(144000, np.int16), "s", 1.0)
    b.dispatch()
    handle = b._inflight[0][0]
    jax.block_until_ready(handle[:2])
    assert b._ready(handle) is True
    assert b.harvest_ready() == 1 and len(out) == 2
    assert b.inflight_depth == 0


def test_device_loop_adaptive_cadence():
    """With a min-tick floor an idle loop runs at the floor (latency
    quantizes to the period); without one it stays at the nominal tick;
    at saturation the period formula (2×busy capped at tick) returns to
    the nominal tick, so throughput behavior is unchanged."""
    loop = DeviceLoop(tick_seconds=0.1, min_tick_seconds=0.005)
    loop.start()
    time.sleep(0.5)
    loop.stop()
    assert loop.ticks >= 20           # ≫ the 5 ticks a fixed 100 ms gives
    assert loop._cur_period <= 0.01   # idle → floor

    fixed = DeviceLoop(tick_seconds=0.05)   # no floor → fixed cadence
    fixed.start()
    time.sleep(0.4)
    fixed.stop()
    assert fixed.ticks <= 10
    assert fixed._cur_period == 0.05

    # saturated: run_tick busy ≥ tick/2 ⇒ period == nominal tick
    busy_loop = DeviceLoop(tick_seconds=0.02, min_tick_seconds=0.001)
    orig = busy_loop.run_tick
    busy_loop.run_tick = lambda: (time.sleep(0.015), orig())[1]
    busy_loop.start()
    time.sleep(0.3)
    busy_loop.stop()
    assert abs(busy_loop._cur_period - 0.02) < 1e-9


# -- results queue ----------------------------------------------------------------------

def test_results_queue_drop_accounting():
    q = ResultsQueue(capacity=2)
    assert q.put(1) and q.put(2)
    assert not q.put(3)
    assert q.dropped == 1 and q.enqueued == 2
    assert q.get() == 1


# -- datastore ----------------------------------------------------------------------------

def _detection(sci="Turdus merula", common="Eurasian Blackbird", conf=0.9,
               ts=1_700_000_000.0, source="s1"):
    import datetime

    from birdnet_go_tpu.analysis.results import Detection
    from birdnet_go_tpu.taxonomy.labels import Species

    return Detection(species=Species(sci, common), confidence=conf,
                     begin_seconds=ts, end_seconds=ts + 12,
                     model_id="BirdNET_V2.4", source_id=source,
                     timestamp=datetime.datetime.fromtimestamp(ts),
                     species_code="eurbla")


def test_datastore_crud_and_contributions():
    from birdnet_go_tpu.analysis.processor import ModelContribution

    ds = Datastore(":memory:")
    det_id = ds.insert_detection(
        _detection(), clip_name="clip.wav",
        contributions={"BirdNET_V2.4": ModelContribution("BirdNET_V2.4", 3, 0.9),
                       "Perch_V2": ModelContribution("Perch_V2", 1, 0.7)})
    row = ds.get_detection(det_id)
    assert row["scientific_name"] == "Turdus merula"
    assert row["clip_name"] == "clip.wav"
    assert len(row["contributions"]) == 2
    assert ds.count_detections() == 1
    assert ds.delete_detection(det_id)
    assert ds.get_detection(det_id) is None


def test_datastore_lock_blocks_delete():
    ds = Datastore(":memory:")
    det_id = ds.insert_detection(_detection())
    ds.lock_detection(det_id)
    with pytest.raises(PermissionError):
        ds.delete_detection(det_id)
    ds.lock_detection(det_id, locked=False)
    assert ds.delete_detection(det_id)


def test_datastore_search_and_analytics():
    ds = Datastore(":memory:")
    for hour in (6, 6, 7, 18):
        ts = 1_700_000_000.0 - 1_700_000_000.0 % 86400 + hour * 3600
        ds.insert_detection(_detection(ts=ts))
    ds.insert_detection(_detection(sci="Parus major", common="Great Tit",
                                   conf=0.6))
    assert len(ds.search_detections(species="Turdus merula")) == 4
    assert len(ds.search_detections(min_confidence=0.8)) == 4
    assert len(ds.search_detections(limit=2)) == 2
    summary = ds.species_summary()
    assert summary[0]["scientific_name"] == "Turdus merula"
    assert summary[0]["count"] == 4
    hist = ds.confidence_histogram()
    assert sum(hist) == 5
    dist = ds.hourly_distribution()
    assert sum(dist) == 5
    reviews = ds.review_detection(1, "correct", "confirmed by ear")
    assert reviews == 1
    with pytest.raises(ValueError):
        ds.review_detection(1, "maybe")


def test_datastore_dynamic_threshold_roundtrip():
    from birdnet_go_tpu.analysis.dynamic_threshold import ThresholdState

    ds = Datastore(":memory:")
    state = {("BirdNET_V2.4", "Turdus merula"): ThresholdState(2, 5, 123.0)}
    ds.save_dynamic_thresholds(state)
    loaded = ds.load_dynamic_thresholds()
    st = loaded[("BirdNET_V2.4", "Turdus merula")]
    assert st.level == 2 and st.high_conf_count == 5 and st.expires_at == 123.0

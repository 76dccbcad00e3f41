"""Consolidated native RTSP demux (native/rtsp_plane.cpp).

The production answer to SURVEY §7's "2,000 streams needs a consolidated
demux strategy" (reference: one FFmpeg subprocess per stream,
internal/audiocore/ffmpeg/stream.go:471-1534): one epoll thread owns
every session. These tests prove, at CI scale, the properties the
500-stream soak leg relies on: exact sample conservation over real
TCP/RTSP, AnalysisBuffer window semantics (overlap continuity,
contiguous indices), reconnect-with-backoff supervision, and G.711
decode + upsample correctness against a numpy oracle.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from birdnet_go_tpu.native.lib import available

if not available():                                    # pragma: no cover
    pytest.skip("native library unavailable", allow_module_level=True)

from birdnet_go_tpu.native.lib import RtspDemux, RtspLoadServer  # noqa: E402

WINDOW, HOP = 48000, 24000      # 1 s / 0.5 s at 48 kHz — fast windows


def _collect_all(dmx, seconds, n_cap=512):
    out = np.empty((n_cap, WINDOW), np.int16)
    meta = np.empty((n_cap, 3), np.int64)
    got = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        n = dmx.collect(out, meta)
        for j in range(n):
            got.append((int(meta[j, 0]), int(meta[j, 1]),
                        int(meta[j, 2]), out[j].copy()))
        time.sleep(0.05)
    return got


def test_l16_e2e_conservation_and_window_semantics():
    srv = RtspLoadServer(rate=48000, n_waveforms=4, seed=7)
    srv.start()
    dmx = RtspDemux(8, 48000, WINDOW, HOP, ring_seconds=6.0)
    try:
        for i in range(8):
            dmx.add(i, "127.0.0.1", srv.port, f"/cam{i}")
        dmx.start()
        got = _collect_all(dmx, 6.0)
        ds, ss = dmx.stats(), srv.stats()

        assert ds["connected"] == 8
        assert ds["samples_lost"] == 0
        assert ss["samples_dropped"] == 0
        # exact conservation: every sample the server sent is either in
        # a ring or was collected — none vanished in the demux
        assert ds["samples_received"] == ss["samples_sent"]
        assert ds["restarts"] == 0
        assert ds["demux_cpu_ns"] > 0          # CPU/stream is measured

        by_stream: dict[int, list] = {}
        for s, idx, ready_ns, w in got:
            by_stream.setdefault(s, []).append((idx, ready_ns, w))
        assert len(by_stream) == 8
        for s, ws in by_stream.items():
            idxs = [i for i, _, _ in ws]
            # contiguous window indices from 0 (no loss ⇒ no index gaps)
            assert idxs == list(range(len(idxs))), f"stream {s}: {idxs}"
            # AnalysisBuffer overlap: window k+1's prefix IS window k's
            # suffix; window 0's overlap prefix is zero-filled
            assert not ws[0][2][: WINDOW - HOP].any()
            for (_, _, a), (_, _, b) in zip(ws, ws[1:]):
                np.testing.assert_array_equal(a[HOP:], b[: WINDOW - HOP])
            # deadlines advance by exactly one hop of realtime
            times = [t for _, t, _ in ws]
            for t0_, t1 in zip(times, times[1:]):
                assert t1 - t0_ == int(HOP / 48000 * 1e9)
            # the signal is alive, not silence
            assert np.ptp(ws[-1][2][WINDOW - HOP:].astype(np.int32)) > 1000
    finally:
        dmx.stop()
        srv.stop()
        dmx.close()
        srv.close()


def test_reconnect_after_server_restart():
    srv = RtspLoadServer(rate=48000, n_waveforms=2, seed=5)
    port = srv.port
    srv.start()
    dmx = RtspDemux(4, 48000, WINDOW, HOP, ring_seconds=4.0)
    try:
        for i in range(4):
            dmx.add(i, "127.0.0.1", port, f"/cam{i}")
        dmx.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and dmx.stats()["connected"] < 4:
            time.sleep(0.1)
        assert dmx.stats()["connected"] == 4

        srv.stop()
        srv.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and dmx.stats()["connected"] > 0:
            time.sleep(0.1)
        assert dmx.stats()["connected"] == 0

        # supervision: sessions come back once a server reappears on the
        # same port (first-retry backoff is 2 s after a quick exit)
        srv = RtspLoadServer(port=port, rate=48000, n_waveforms=2, seed=5)
        srv.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline \
                and dmx.stats()["connected"] < 4:
            time.sleep(0.2)
        ds = dmx.stats()
        assert ds["connected"] == 4
        assert ds["restarts"] >= 4
    finally:
        dmx.stop()
        srv.stop()
        dmx.close()
        srv.close()


def test_soak_rtsp_ingest_mode_end_to_end():
    """`soak --ingest rtsp` at CI scale: real TCP/RTSP sessions through
    the consolidated demux feed the production scheduler → processor →
    datastore, with measured demux CPU and zero unaccounted loss — the
    wiring a 500-stream soak leg scales up."""
    from birdnet_go_tpu.scheduler.soak import run_soak

    rec = run_soak(streams=8, seconds=6.0, ingest="rtsp",
                   action_mix="db", hit_stride=4, sample_seconds=2.0)
    ing = rec["ingest"]
    assert ing["type"] == "rtsp"
    assert ing["connected_at_end"] == 8
    assert ing["session_restarts"] == 0
    assert ing["samples_dropped_by_server"] == 0
    assert ing["demux_cpu_core_pct"] > 0
    da = rec["drop_accounting"]
    assert da["farm_samples_lost"] == 0
    assert da["scheduler_windows_dropped"] == 0
    assert rec["windows_processed"] > 0
    assert rec["actions"]["detections_persisted"] > 0


def test_soak_rtsp_mode_rejects_multi_model_and_tpu():
    from birdnet_go_tpu.scheduler.soak import run_soak

    with pytest.raises(ValueError):
        run_soak(streams=4, seconds=1.0, ingest="rtsp",
                 models=("BirdNET_V2.4", "Perch_V2"))
    with pytest.raises(ValueError):
        run_soak(streams=4, seconds=1.0, ingest="rtsp", device="device")
    with pytest.raises(ValueError):
        run_soak(streams=4, seconds=1.0, ingest="nope")


def _mulaw_encode(pcm: np.ndarray) -> bytes:
    from tests.test_rtsp_e2e import _mulaw_encode as enc

    return enc(pcm)


def test_pcmu_upsample_matches_numpy_oracle():
    """G.711 µ-law at 8 kHz through the demux → 48 kHz via table decode +
    linear interpolation; verified sample-exact against a numpy
    replication of the same ramp (including cross-packet continuity)."""
    from birdnet_go_tpu.audio.rtsp import MULAW
    from tests.test_rtsp_e2e import MiniRtspServer

    rng = np.random.default_rng(11)
    t = np.arange(16000) / 8000.0
    pcm8 = (6000 * np.sin(2 * np.pi * 440 * t)
            + rng.normal(0, 150, t.size)).astype(np.int16)
    srv = MiniRtspServer(pcm8, rate=8000, codec="PCMU")
    srv.start()
    dmx = RtspDemux(1, 48000, WINDOW, HOP, ring_seconds=8.0)
    try:
        dmx.add(0, "127.0.0.1", srv.port, "/stream1")
        dmx.start()
        expected_n = pcm8.size * 6
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline \
                and dmx.stats()["samples_received"] < expected_n:
            time.sleep(0.1)
        # stop BEFORE the mini server re-streams to a reconnect
        dmx.stop()
        assert dmx.stats()["samples_received"] >= expected_n

        # numpy oracle: decode table + the exact integer ramp the C++
        # uses (prev + (cur-prev)*k/up, truncating division, prev=0 at
        # session start, carried across packet boundaries)
        dec = MULAW[np.frombuffer(_mulaw_encode(pcm8), np.uint8)] \
            .astype(np.int64)
        prev = np.concatenate([[0], dec[:-1]])
        k = np.arange(1, 7)
        ramp = prev[:, None] + ((dec - prev)[:, None] * k[None, :]) // 6
        # C++ int division truncates toward zero; numpy // floors —
        # recompute the negative-delta cells the trunc way
        neg = ((dec - prev) < 0)
        ramp[neg] = (prev[neg, None]
                     + -((-(dec - prev)[neg, None] * k[None, :]) // 6))
        oracle = ramp.reshape(-1).astype(np.int16)

        out = np.empty((64, WINDOW), np.int16)
        meta = np.empty((64, 3), np.int64)
        stream = []
        while True:
            n = dmx.collect(out, meta)
            if n == 0:
                break
            for j in range(n):
                stream.append(out[j, WINDOW - HOP:].copy())
        rebuilt = np.concatenate(stream)
        m = min(len(rebuilt), len(oracle))
        assert m >= HOP
        np.testing.assert_array_equal(rebuilt[:m], oracle[:m])
    finally:
        dmx.stop()
        srv.stop()
        dmx.close()

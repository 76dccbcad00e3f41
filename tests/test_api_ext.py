"""Extended API surface: notifications, dynamic thresholds, system detail,
comments, imports, taxonomy, weather extras (handlers_ext.py)."""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from tests.test_app_integration import tiny_app  # fixture
from tests.test_realtime_core import _detection

M = "BirdNET_V2.4"


def _req(port, path, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v2{path}", data=data,
        headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture()
def served(tiny_app):
    tiny_app.start(warmup=False)
    yield tiny_app, tiny_app.settings.webserver.port
    tiny_app.stop()


def test_notifications_crud_and_test_endpoint(served):
    app, port = served
    out = _req(port, "/notifications/test", "POST",
               {"title": "Hi", "message": "msg", "priority": "high"})
    assert "delivered" in out
    lst = _req(port, "/notifications")
    assert lst["unread"] == 1
    nid = lst["notifications"][0]["id"]
    assert lst["notifications"][0]["title"] == "Hi"
    one = _req(port, f"/notifications/{nid}")
    assert one["priority"] == "high"
    assert _req(port, f"/notifications/{nid}/read", "PUT")["read"]
    assert _req(port, "/notifications/unread/count")["count"] == 0
    _req(port, "/notifications/test", "POST", {})
    assert _req(port, "/notifications/read-all", "PUT")["marked"] == 1
    assert _req(port, f"/notifications/{nid}", "DELETE")["deleted"]
    with pytest.raises(urllib.error.HTTPError):
        _req(port, f"/notifications/{nid}")


def test_dynamic_threshold_endpoints(served):
    app, port = served
    app.processor.dynamic.learn(0.95, M, "Turdus merula", now=time.time())
    lst = _req(port, "/dynamic-thresholds")
    assert lst["thresholds"][0]["scientific_name"] == "Turdus merula"
    assert lst["thresholds"][0]["level"] == 1
    stats = _req(port, "/dynamic-thresholds/stats")
    assert stats["species_tracked"] == 1
    assert _req(port, "/dynamic-thresholds/Turdus%20merula",
                "DELETE")["cleared"] == 1
    assert _req(port, "/dynamic-thresholds")["thresholds"] == []
    assert "events" in _req(port, "/dynamic-thresholds/events")


def test_system_detail_and_control(served):
    app, port = served
    procs = _req(port, "/system/processes?limit=5")["processes"]
    assert procs and procs[0]["rss_bytes"] > 0
    disks = _req(port, "/system/disks")["disks"]
    assert any(d["mountpoint"] == "/" for d in disks)
    assert "available" in _req(port, "/system/temperature/cpu")
    diag = _req(port, "/system/diagnostics")
    assert M in diag["models_loaded"]
    sigs = _req(port, "/system/control/signals")["signals"]
    assert "rebuild_range_filter" in sigs and len(sigs) >= 20
    sent = _req(port, "/system/control", "POST",
                {"signal": "update_detection_intervals"})
    assert sent["sent"] == "update_detection_intervals"
    with pytest.raises(urllib.error.HTTPError):
        _req(port, "/system/control", "POST", {"signal": "nope"})


def test_devices_and_stream_probe(served):
    app, port = served
    d = _req(port, "/devices")
    assert "devices" in d and "alsa_available" in d
    out = _req(port, "/streams/test", "POST",
               {"url": f"http://127.0.0.1:{port}/api/v2/ping"})
    assert out["ok"] is True and out["connect_ms"] >= 0
    with pytest.raises(urllib.error.HTTPError):
        _req(port, "/streams/test", "POST", {"url": "ftp://x/"})
    qh = _req(port, "/quiet-hours/status")
    assert "sources" in qh


def test_detection_comments_reviews_new(served):
    app, port = served
    det_id = app.datastore.insert_detection(_detection())
    cid = _req(port, f"/detections/{det_id}/comments", "POST",
               {"text": "great catch"})["comment_id"]
    comments = _req(port, f"/detections/{det_id}/comments")["comments"]
    assert comments[0]["text"] == "great catch"
    assert _req(port, f"/comments/{cid}", "PUT",
                {"text": "edited"})["updated"]
    assert _req(port, f"/detections/{det_id}/comments"
                )["comments"][0]["text"] == "edited"
    assert _req(port, f"/comments/{cid}", "DELETE")["deleted"]
    # reviews listing + unlock
    _req(port, f"/detections/{det_id}/review", "POST",
         {"verdict": "correct"})
    assert _req(port, f"/detections/{det_id}/reviews"
                )["reviews"][0]["verdict"] == "correct"
    _req(port, f"/detections/{det_id}/lock", "POST", {"locked": True})
    assert _req(port, f"/detections/{det_id}/lock", "DELETE")["locked"] \
        is False
    # /detections/new
    new = _req(port, f"/detections/new?since={0}")
    assert new["count"] >= 1
    # the detail page fetches one detection and must see the latest
    # verdict without an extra reviews round-trip (views/detail.js)
    one = _req(port, f"/detections/{det_id}")
    assert one["verdict"] == "correct"
    assert one["contributions"] == []


def test_system_database_details(served):
    """GET /system/database mirrors the reference's storage
    observability cards (table breakdown, WAL, detection rate)."""
    app, port = served
    app.datastore.insert_detection(_detection(ts=time.time()))
    db = _req(port, "/system/database")
    assert db["engine"] == "sqlite"
    assert db["journal_mode"] in ("wal", "memory", "delete")
    names = {tb["table"] for tb in db["tables"]}
    assert "detections" in names and "reviews" in names
    det_row = next(tb for tb in db["tables"] if tb["table"] == "detections")
    assert det_row["rows"] >= 1
    assert len(db["detections_per_hour_24h"]) == 24
    assert sum(db["detections_per_hour_24h"]) >= 1


def test_detections_csv_export(served):
    """GET /detections/export streams the filtered table as CSV (the
    reference import-export page lists this as planned)."""
    app, port = served
    det_id = app.datastore.insert_detection(_detection(conf=0.93))
    app.datastore.insert_detection(_detection(sci="Parus major",
                                              common="Great Tit", conf=0.4))
    app.datastore.review_detection(det_id, "correct")
    url = (f"http://127.0.0.1:{port}/api/v2/detections/export"
           f"?min_confidence=0.9&format=csv")
    with urllib.request.urlopen(url) as resp:
        assert resp.headers["Content-Type"].startswith("text/csv")
        assert "attachment" in resp.headers["Content-Disposition"]
        lines = resp.read().decode().strip().splitlines()
    header = lines[0].split(",")
    assert header[:4] == ["id", "date", "time", "scientific_name"]
    body_rows = [ln for ln in lines[1:] if ln]
    assert len(body_rows) == 1 and "correct" in body_rows[0]
    assert "Parus major" not in "".join(body_rows)
    # bad filter → 400, unknown format → 400
    for bad in ("?min_confidence=abc", "?format=xlsx"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v2/detections/export{bad}")
        assert ei.value.code == 400
    # negative limit clamps to 1 row — 'LIMIT -1' would mean UNLIMITED
    # in sqlite and a syntax error on MySQL
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v2/detections/export?limit=-1"
            ) as resp:
        neg_rows = [ln for ln in resp.read().decode().strip()
                    .splitlines()[1:] if ln]
    assert len(neg_rows) == 1


def test_advanced_search_filters(served):
    app, port = served
    det_id = app.datastore.insert_detection(_detection(conf=0.9))
    app.datastore.insert_detection(_detection(sci="Parus major",
                                              common="Great Tit", conf=0.6))
    app.datastore.review_detection(det_id, "correct")
    rows = _req(port, "/detections/search", "POST",
                {"verified": "correct"})
    assert rows["count"] == 1
    # rows carry the latest verdict for UI badges (VerificationBadges)
    assert rows["detections"][0]["verdict"] == "correct"
    rows = _req(port, "/detections/search", "POST",
                {"verified": "unreviewed"})
    assert rows["count"] == 1
    assert rows["detections"][0]["scientific_name"] == "Parus major"
    rows = _req(port, "/detections/search", "POST",
                {"max_confidence": 0.7})
    assert rows["count"] == 1


def test_species_taxonomy_weather(served):
    app, port = served
    allsp = _req(port, "/species/all")
    assert allsp["total"] == 6
    found = _req(port, "/species/search?q=tu")
    assert "species" in found
    tree = _req(port, "/taxonomy/tree")
    assert tree["genera"] >= 1
    moon = _req(port, "/weather/moon/2026-08-16")
    assert 0 <= moon["illumination"] <= 1
    kpis = _req(port, "/analytics/dashboard/kpis")
    assert "detections_total" in kpis
    stats = _req(port, "/analytics/database/stats")
    assert stats["detections"] >= 0


def test_import_jobs_flow(served, tmp_path):
    app, port = served
    logf = tmp_path / "BirdDB.txt"
    logf.write_text(
        "Date;Time;Sci_Name;Com_Name;Confidence\n"
        "2026-01-02;07:31:00;Turdus merula;Eurasian Blackbird;0.91\n"
        "2026-01-02;07:32:00;Parus major;Great Tit;0.81\n")
    job = _req(port, "/imports/birdnet-pi", "POST",
               {"path": str(logf)})["job"]
    deadline = time.time() + 10
    while time.time() < deadline:
        j = _req(port, f"/imports/jobs/{job['id']}")
        if j["status"] in ("completed", "failed"):
            break
        time.sleep(0.1)
    assert j["status"] == "completed" and j["imported"] == 2
    assert _req(port, "/imports/jobs")["jobs"]
    with pytest.raises(urllib.error.HTTPError):
        _req(port, "/imports/birdnet-pi", "POST", {"path": "/nope"})


def test_filesystem_and_put_settings(served):
    app, port = served
    from pathlib import Path

    clips = Path(app.settings.export.path)
    clips.mkdir(parents=True, exist_ok=True)
    (clips / "a.wav").write_bytes(b"x" * 10)
    fs = _req(port, "/filesystem/clips")
    assert fs["count"] == 1 and fs["files"][0]["size_bytes"] == 10
    out = _req(port, "/settings", "PUT", {
        "realtime": {"interval_seconds": 22.0},
        "dog_bark_filter": {"enabled": True},
    })
    assert set(out["updated"]) == {"realtime", "dog_bark_filter"}
    assert app.settings.realtime.interval_seconds == 22.0
    assert app.settings.dog_bark_filter.enabled is True


def test_terminal_ws_pty_roundtrip(served):
    """WS ↔ PTY bridge: run a command, read its output (system/ws)."""
    import asyncio

    import aiohttp

    app, port = served

    async def drive():
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(
                    f"http://127.0.0.1:{port}/api/v2/system/ws") as ws:
                await ws.send_str("echo bn$((40+2))\n")
                buf = ""
                for _ in range(60):
                    msg = await ws.receive(timeout=5)
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        buf += msg.data.decode(errors="replace")
                    if "bn42" in buf:
                        return True
                return False

    assert asyncio.new_event_loop().run_until_complete(drive())


def test_terminal_refuses_proxied_without_auth(served):
    app, port = served
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v2/system/ws",
        headers={"X-Forwarded-For": "203.0.113.5"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 403


def test_range_extras_and_alert_import_export(served):
    app, port = served
    # range count (no location configured → disabled)
    out = _req(port, "/range/species/count")
    assert "enabled" in out
    # CSV export
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v2/range/species/csv",
            timeout=10) as r:
        assert "text/csv" in r.headers["Content-Type"]
        assert r.read().startswith(b"scientific_name")
    # alert rules roundtrip: create → export → wipe → import
    _req(port, "/alerts/rules", "POST", {
        "rule_id": "r1", "name": "owls", "species": ["Strix aluco"]})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v2/alerts/rules/export",
            timeout=10) as r:
        doc = json.loads(r.read())
    assert doc["version"] == 1 and len(doc["rules"]) == 1
    _req(port, "/alerts/rules/r1", "DELETE")
    out = _req(port, "/alerts/rules/import", "POST", doc)
    assert out["imported"] == 1 and out["failed"] == 0
    assert any(r["rule_id"] == "r1" for r in _req(port, "/alerts/rules"))


def test_pending_snapshot_and_broadcast(served):
    app, port = served
    from birdnet_go_tpu.analysis.processor import WindowPrediction

    events = []
    app.processor.on_pending = events.append
    now = time.time()
    app.processor.submit(WindowPrediction(
        source_id="s1", model_id=M, start_time=now, end_time=now + 3,
        indices=[0], confidences=[0.9]))
    out = _req(port, "/detections/pending")
    assert out["pending"] and out["pending"][0]["count"] == 1
    assert app.processor.broadcast_pending() is True
    assert app.processor.broadcast_pending() is False   # deduplicated
    assert events and events[0][0]["source_id"] == "s1"


def test_streams_health_sse(served):
    app, port = served
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v2/streams/health/stream")
    with urllib.request.urlopen(req, timeout=10) as r:
        chunk = r.read(200)
    assert b"event: health" in chunk


def test_http_metrics_and_config_warning_notifications(served):
    app, port = served
    _req(port, "/ping")
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    assert "http_requests_total" in text
    assert 'route="/api/v2/ping"' in text
    assert "http_request_duration_seconds" in text


def test_config_warnings_surface_as_notifications(tmp_path, monkeypatch):
    from birdnet_go_tpu.app import Application
    from birdnet_go_tpu.config.settings import ModelSettings, Settings
    import birdnet_go_tpu.app as app_mod
    from birdnet_go_tpu.inference import loader as _ldr
    from tests.test_app_integration import tiny_app as _f  # noqa: F401

    # reuse the tiny model loader via monkeypatching
    import jax
    import jax.numpy as jnp

    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
    from birdnet_go_tpu.models.efficientnet import (
        BlockSpec,
        EfficientNetConfig,
    )
    from birdnet_go_tpu.ops.melspec import MelConfig

    def tiny(model_id, checkpoint=None, seed=0, **kw):
        m = BirdNETv24(num_species=4,
                       mel=MelConfig(sample_rate=48000, n_fft=256, hop=8192,
                                     n_mels=16), compute_dtype=jnp.float32)
        m.net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                                   embedding_dim=8, num_classes=4)
        return m, m.init(jax.random.PRNGKey(0))

    monkeypatch.setattr(app_mod, "load_model", tiny)
    s = Settings()
    s.models = [ModelSettings(model_id="BirdNET_V2.4",
                              sensitivity=9.0)]     # invalid → warning
    s.database.path = str(tmp_path / "w.db")
    s.webserver.enabled = False
    app = Application(s)
    app.setup()
    notes = app.notification_inbox.list()
    assert any("sensitivity" in n["message"] for n in notes)
    assert notes[0]["title"] == "Configuration warning"


def test_diel_and_trend_analytics_endpoints(served):
    """New analytics routes (reference TimeOfDaySpeciesChart /
    DailySpeciesTrendChart): per-species diel profiles + daily trend —
    and the pre-existing /detections/{id}/time-of-day route must keep
    resolving to the sun-position handler (regression: name collision)."""
    import datetime as dt

    app, port = served
    noon = dt.datetime.now().replace(hour=12, minute=0, second=0)
    det_id = app.datastore.insert_detection(
        _detection(ts=noon.timestamp()))
    today = noon.date().isoformat()
    tod = _req(port, f"/analytics/time-of-day?from={today}&to={today}")
    assert tod["species"][0]["hourly"][12] == 1
    assert tod["species"][0]["total"] == 1
    trend = _req(port,
                 f"/analytics/species-daily-trend?from={today}&to={today}")
    assert trend["species"][0]["daily"] == {today: 1}
    # sun-position route still answers (400 without location is fine)
    try:
        out = _req(port, f"/detections/{det_id}/time-of-day")
        assert "time_of_day" in out or "error" in out
    except urllib.error.HTTPError as e:
        assert e.code == 400
    # ?species= narrows to one species (drill-down diel clock)
    sci = tod["species"][0]["scientific_name"]
    one = _req(port, f"/analytics/time-of-day?from={today}&to={today}"
               f"&species={urllib.parse.quote(sci)}")
    assert len(one["species"]) == 1 \
        and one["species"][0]["scientific_name"] == sci
    # bad ?top= is a 400, not a 500; negative clamps instead of slicing
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(port, f"/analytics/time-of-day?from={today}&to={today}&top=abc")
    assert ei.value.code == 400
    neg = _req(port, f"/analytics/time-of-day?from={today}&to={today}&top=-3")
    assert len(neg["species"]) == 1    # clamped to ≥1, not a negative slice

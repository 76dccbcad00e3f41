"""Crash-durability soak leg: SIGKILL a mid-run durable soak, recover,
restart, and emit a machine-checkable record (VERDICT r4 #4's SOAK leg).

Mirrors tests/test_crash_durability.py as a scale proof instead of a CI
gate: a victim subprocess runs the full pipeline (C++ farm → scheduler →
processor → jobqueue → SQLite WAL + clip files) in durable mode; this
orchestrator SIGKILLs it mid-write, runs
`analysis.recovery.recover_startup()` (the production restart path the
`birdnet-tpu recover` CLI exposes), proves idempotency, then runs a
restart leg IN the recovered database and asserts the exact row
equation `after == before + persisted` — no detection double-counted
across the crash.

Reference semantics: main.go:63-83 (restart-on-exit-42 must come back
from unclean death), processor/threshold_persistence.go (periodic
snapshot + restore), internal/diskmanager (clip↔DB reconcile),
species_tracker InitFromDatabase (first-seen resync).

Run: BIRDNET_TPU_PLATFORM=cpu python -m birdnet_go_tpu.scheduler.crashleg \
         --streams 1000 --out crashleg.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

log = logging.getLogger("birdnet_tpu.crashleg")


def _ro_count(db: Path, sql: str) -> int:
    """Read-only poll of the victim's live WAL database."""
    try:
        con = sqlite3.connect(f"file:{db}?mode=ro", uri=True, timeout=2.0)
    except sqlite3.OperationalError:
        return 0
    try:
        return int(con.execute(sql).fetchone()[0])
    except sqlite3.OperationalError:
        return 0
    finally:
        con.close()


def run_crash_leg(streams: int = 1000, kill_min_rows: int = 200,
                  restart_seconds: float = 30.0,
                  persist_interval_s: float = 2.0,
                  hit_stride: int = 4,
                  workdir: str | None = None) -> dict[str, Any]:
    from birdnet_go_tpu.analysis.recovery import recover_startup
    from birdnet_go_tpu.datastore.sqlite import Datastore
    from birdnet_go_tpu.scheduler.soak import run_soak

    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="crashleg_")
        workdir = tmp.name
    root = Path(workdir)
    db = root / "birds.db"
    clips = root / "clips"
    repo = Path(__file__).resolve().parents[2]

    rec: dict[str, Any] = {
        "leg": "crash_durability",
        "streams": streams,
        "durable": {"persist_interval_s": persist_interval_s,
                    "hit_stride": hit_stride},
    }

    # ---- victim: full pipeline in durable mode, killed mid-write ----
    env = dict(os.environ, BIRDNET_TPU_PLATFORM="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "birdnet_go_tpu.cli", "soak",
         "--streams", str(streams), "--seconds", "300",
         "--db", str(db), "--clips-dir", str(clips),
         "--durable", "--persist-interval", str(persist_interval_s),
         "--hit-stride", str(hit_stride)],
        cwd=repo, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.monotonic()
    try:
        deadline = t0 + 180.0
        rows = thr = 0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"victim exited early rc={proc.returncode}")
            rows = _ro_count(db, "SELECT COUNT(*) FROM detections")
            thr = _ro_count(db, "SELECT COUNT(*) FROM dynamic_thresholds")
            if rows >= kill_min_rows and thr >= 1:
                break
            time.sleep(0.5)
        else:
            raise RuntimeError(
                f"victim never reached kill state rows={rows} thr={thr}")
        time.sleep(0.7)              # more jobs in flight at the kill
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)

    wal = db.with_name(db.name + "-wal")
    rec["victim"] = {
        "killed_at_s": round(time.monotonic() - t0, 1),
        "signal": "SIGKILL",
        "returncode": proc.returncode,
        "rows_committed_before_kill": rows,
        "thresholds_before_kill": thr,
        "clips_on_disk_at_kill": sum(
            1 for p in clips.rglob("*") if p.is_file()) if clips.exists()
            else 0,
        "wal_left_behind_bytes": wal.stat().st_size if wal.exists() else 0,
    }

    # ---- recovery: the production restart path, then prove idempotency --
    future = time.time() + 3600.0    # bypass clip recency guards: every
    # orphan in this leg was written seconds ago; production keeps them
    # until the recency window passes (see recovery.py docstring)
    ledger = recover_startup(str(db), clips_dir=str(clips), now=future)
    again = recover_startup(str(db), clips_dir=str(clips), now=future)
    rec["recovery_ledger"] = ledger
    rec["recovery_idempotent"] = (
        again["integrity"] == "ok"
        and again["detections"] == ledger["detections"]
        and again["clips"]["orphan_files_swept"] == 0
        and again["clips"]["dangling_refs_cleared"] == 0)

    # ---- restart leg: append to the recovered DB, exact row equation ---
    store = Datastore(str(db))
    try:
        before = store.count_detections()
        thresholds_before = len(store.load_dynamic_thresholds())
    finally:
        store.close()

    r2 = run_soak(streams=streams, seconds=restart_seconds,
                  db_path=str(db), clips_dir=str(clips), durable=True,
                  persist_interval_s=persist_interval_s,
                  hit_stride=hit_stride, sim_mqtt_ms=1.0, sim_alert_ms=1.0)
    persisted = r2["actions"]["detections_persisted"]

    store = Datastore(str(db))
    try:
        after = store.count_detections()
        dups = store.count_duplicate_detections()
        integ = store.integrity_check()
    finally:
        store.close()

    rec["restart"] = {
        "seconds": restart_seconds,
        "detections_before": before,
        "detections_persisted": persisted,
        "detections_after": after,
        "exact_count_equation_holds": after == before + persisted,
        "duplicate_detections": dups,
        "integrity": integ,
        "thresholds_restored_ge_before_kill":
            r2["durable"]["thresholds_persisted"] >= thresholds_before,
        "latency_ms": r2["latency_ms"],
        "drop_accounting": r2["drop_accounting"],
    }
    rec["pass"] = bool(
        ledger["integrity"] == "ok"
        and ledger["duplicate_detections"] == 0
        and ledger["thresholds_restored"] >= 1
        and ledger["species_resynced"] >= 1
        and rec["recovery_idempotent"]
        and rec["restart"]["exact_count_equation_holds"]
        and dups == 0 and integ == "ok"
        and persisted > 0)
    if tmp is not None:
        tmp.cleanup()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--streams", type=int, default=1000)
    p.add_argument("--kill-min-rows", type=int, default=200)
    p.add_argument("--restart-seconds", type=float, default=30.0)
    p.add_argument("--out", default=None,
                   help="append the record to this JSON file's 'runs'")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec = run_crash_leg(streams=args.streams,
                        kill_min_rows=args.kill_min_rows,
                        restart_seconds=args.restart_seconds)
    print(json.dumps(rec, indent=1))
    if args.out:
        path = Path(args.out)
        doc = (json.loads(path.read_text()) if path.exists()
               else {"runs": []})
        doc["runs"].append(rec)
        path.write_text(json.dumps(doc, indent=1))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

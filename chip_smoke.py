"""Smoke run of BirdNET v2.4 serving and offline analysis on one GPU.

    python chip_smoke.py [--seed N] [--out DIR]    # one card, phases 1-5
    python chip_smoke.py --four-cards              # sharded serving, 4 cards

One process holds the card(s); nothing it starts opens a card. Weights are
random from `--seed`, audio is generated from it (tones plus noise), and
every model runs at full width: 144,000-sample windows at 48 kHz, mel with
n_fft 2048 / hop 512 / 96 mels, EfficientNet-B0, 6,522 classes.

Phases (each prints its numbers; any failure exits non-zero and prints no
result line):
  1. device     card name and power limit, JAX version, devices; fails
                unless the platform is "gpu"
  2. reference  the mel front end against a float64 numpy rFFT, and the
                production step's confidences against a float32 reference
                of the same parameters on the CPU backend
  3. offline    `birdnet-tpu analyze` in-process on a generated WAV; the
                Raven table must hold one row per window
  4. served     Application with tone and file sources, max_batch 256;
                detections are read back from its SQLite file
  5. timings    the production step and the front end alone (both XLA
                DFT routes) at batch 256 and 1024

With --four-cards only the four-card phase runs: ShardedClassifier under
ModelBatcher/DeviceLoop on the default 2×2 mesh against the one-card step.

The last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sqlite3
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEFAULT_OUT = ROOT / "chiprun_out" / "chip_smoke"

# Front-end tolerances, as max |error| over the largest value of the
# float64 reference (stated with the precision of each dot):
#  - power spectrum, matmul DFT route: both DFT stages are float32 einsums
#    at Precision.HIGHEST — float32 rounding only;
#  - power spectrum, rfft route: float32 FFT;
#  - mel power: adds the [n_bins → n_mels] projection, which names no
#    precision, so the GPU may run it in TF32 (10-bit mantissa, unit
#    roundoff 2^-11 ≈ 4.9e-4); 4× that covers accumulation.
TOL_SPECTRUM = 1e-4
TOL_MEL = 2e-3
# Confidence gate of the bf16 step against the float32 reference (the
# repo's int8/bf16 parity gate, tests/test_quantized.py): post-sigmoid
# confidences of the same species within 0.02, top-10 sets overlap ≥ 9/10.
# Random-init logits are large enough to saturate the sigmoid at
# sensitivity 1 (every top-10 confidence rounds to 1.0 in float32, which
# makes the top-10 order a tie-break), so the comparison runs at the
# sensitivity that maps the reference's largest |logit| to CONF_LOGIT_SPAN.
TOL_CONF = 0.02
MIN_TOP10_OVERLAP = 0.9
CONF_LOGIT_SPAN = 4.0


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


# -- audio --------------------------------------------------------------------


def make_audio(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Seeded int16 mono: a few tones with slow amplitude envelopes + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * rate))) / rate
    x = 0.02 * rng.standard_normal(t.shape)
    for _ in range(4):
        f = rng.uniform(800.0, 9000.0)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        x += rng.uniform(0.05, 0.2) * env * np.sin(
            2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def make_windows(batch: int, samples: int, rate: int, seed: int
                 ) -> np.ndarray:
    return np.stack([make_audio(samples / rate, rate, seed + i)[:samples]
                     for i in range(batch)])


# -- phase 1 ------------------------------------------------------------------


def phase_device(require_platform: str = "gpu"):
    import jax

    dev = jax.devices()[0]
    if dev.platform != require_platform:
        raise SystemExit(f"chip_smoke needs a {require_platform} device; JAX "
                         f"found {dev.platform!r} ({dev.device_kind})")
    import bench

    say("device", card=repr(bench.card_name_and_power()))
    say("device", jax=jax.__version__, devices=repr(jax.devices()),
        kind=repr(dev.device_kind), count=len(jax.devices()))
    return dev


# -- phase 2 ------------------------------------------------------------------


def reference_spectrum(pcm_f64: np.ndarray, cfg) -> np.ndarray:
    """float64 numpy power spectrum [B, F, n_bins] of the framed signal."""
    from birdnet_go_tpu.ops.melspec import _window_fn

    f = cfg.num_frames(pcm_f64.shape[-1])
    idx = np.arange(f)[:, None] * cfg.hop + np.arange(cfg.n_fft)[None, :]
    frames = pcm_f64[..., idx] * _window_fn(cfg).astype(np.float64)
    spec = np.fft.rfft(frames, axis=-1)
    return spec.real ** 2 + spec.imag ** 2


ROUTES = (("matmul", True), ("rfft", False))    # MelConfig.use_matmul_fft


def check_frontend(cfg, pcm_i16: np.ndarray, routes=ROUTES) -> dict:
    """XLA DFT routes on the default device against float64 numpy.

    Returns relative errors; raises SmokeFailure past the tolerances."""
    import jax
    import jax.numpy as jnp

    from birdnet_go_tpu.ops.melspec import (
        _mel_filterbank_np,
        _spectrum,
        frame_signal,
        melspec,
    )

    pcm64 = pcm_i16.astype(np.float64) / 32768.0
    ref_pow = reference_spectrum(pcm64, cfg)
    fb = _mel_filterbank_np(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                            cfg.fmin, cfg.fmax).astype(np.float64)
    ref_mel = ref_pow @ fb
    x = jnp.asarray(pcm_i16.astype(np.float32) / 32768.0)
    errors = {}
    for route, use_matmul in routes:
        c = dataclasses.replace(cfg, use_matmul_fft=use_matmul,
                                mag_scale="linear", power=2.0)
        spec = jax.jit(lambda v, c=c: _spectrum(frame_signal(v, c), c))(x)
        mel = jax.jit(lambda v, c=c: melspec(v, c))(x)
        e_spec = float(np.max(np.abs(np.asarray(spec, np.float64) - ref_pow))
                       / np.max(ref_pow))
        e_mel = float(np.max(np.abs(np.asarray(mel, np.float64) - ref_mel))
                      / np.max(ref_mel))
        errors[route] = {"spectrum": e_spec, "mel": e_mel}
        say("reference", route=route, spectrum_rel_err=f"{e_spec:.3e}",
            spectrum_tol=TOL_SPECTRUM, mel_rel_err=f"{e_mel:.3e}",
            mel_tol=TOL_MEL)
        check(e_spec <= TOL_SPECTRUM,
              f"{route} power spectrum error {e_spec:.3e} > {TOL_SPECTRUM}")
        check(e_mel <= TOL_MEL,
              f"{route} mel power error {e_mel:.3e} > {TOL_MEL}")
    return errors


def check_confidences(model, ref_model, params, pcm_i16: np.ndarray,
                      k: int = 10) -> dict:
    """Production step (default device, the model's compute dtype) against
    `ref_model` (float32) on the CPU backend at 'highest' precision."""
    import jax
    import jax.numpy as jnp

    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.ops.postprocess import sigmoid_confidence
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    batch = pcm_i16.shape[0]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        p_cpu = jax.device_put(params, cpu)
        x = jnp.asarray(pcm_i16.astype(np.float32) / 32768.0)
        logits = np.asarray(jax.jit(
            lambda p, v: ref_model.apply(p, v)["logits"])(p_cpu, x))
    sens = float(min(1.0, CONF_LOGIT_SPAN / np.max(np.abs(logits))))
    ref = np.asarray(sigmoid_confidence(jnp.asarray(logits), sens))

    b = ModelBatcher(JaxClassifier(model, params), max_batch=batch, top_k=k)
    vals, idx, _ = b._step(b.classifier.params, b._put(pcm_i16),
                           jnp.float32(sens), b.top_k, None)
    vals, idx = np.asarray(vals), np.asarray(idx)
    same_species = np.take_along_axis(ref, idx, axis=1)
    delta = float(np.max(np.abs(same_species - vals)))
    ref_top = np.argsort(-ref, axis=1)[:, :k]
    overlap = float(np.mean([len(set(ref_top[i]) & set(idx[i])) / k
                             for i in range(batch)]))
    top1 = float(np.mean(ref_top[:, 0] == idx[:, 0]))
    say("reference", batch=batch, sensitivity=f"{sens:.4g}",
        ref_max_abs_logit=f"{np.max(np.abs(logits)):.3f}",
        max_conf_delta=f"{delta:.4e}",
        conf_tol=TOL_CONF, top10_overlap=f"{overlap:.3f}",
        overlap_min=MIN_TOP10_OVERLAP, top1_agree=f"{top1:.3f}",
        conf_range=f"[{vals.min():.4f},{vals.max():.4f}]")
    check(np.all(np.isfinite(vals)), "non-finite confidences")
    check(delta < TOL_CONF, f"confidence delta {delta:.4f} >= {TOL_CONF}")
    check(overlap >= MIN_TOP10_OVERLAP,
          f"top-{k} overlap {overlap:.3f} < {MIN_TOP10_OVERLAP}")
    return {"max_conf_delta": delta, "top10_overlap": overlap,
            "top1_agree": top1, "sensitivity": sens}


def phase_reference(model, ref_model, params, batch: int, seed: int) -> dict:
    spec = model.spec
    pcm = make_windows(batch, spec.clip_samples, spec.sample_rate, seed)
    return {"frontend": check_frontend(model.mel, pcm),
            "confidences": check_confidences(model, ref_model, params, pcm)}


# -- phase 3 ------------------------------------------------------------------


def phase_offline(out: Path, seed: int, seconds: float = 31.5,
                  model_id: str = "BirdNET_V2.4", rate: int = 48000,
                  clip_seconds: float = 3.0) -> dict:
    from birdnet_go_tpu import native
    from birdnet_go_tpu.audio.wav import write_wav
    from birdnet_go_tpu.cli.main import main as cli_main

    out.mkdir(parents=True, exist_ok=True)
    wav = out / "smoke.wav"
    write_wav(wav, make_audio(seconds, rate, seed), rate)
    raven_dir = out / "raven"
    t0 = time.perf_counter()
    rc = cli_main(["analyze", str(wav), "--model", model_id,
                   "--threshold", "1e-6", "--output", str(raven_dir)])
    elapsed = time.perf_counter() - t0
    check(rc == 0, f"analyze exited {rc}")
    table = raven_dir / (wav.name + ".txt")
    check(table.is_file(), f"no Raven table at {table}")
    lines = table.read_text(encoding="utf-8").splitlines()
    rows = [ln for ln in lines[1:] if ln.strip()]
    expected = int(np.ceil(seconds / clip_seconds))
    say("offline", wav_seconds=seconds, raven_rows=len(rows),
        expected_windows=expected, analyze_s=f"{elapsed:.2f}",
        native_lib="used" if native.available() else "pure-Python fallback")
    check(len(rows) == expected,
          f"Raven table has {len(rows)} rows, expected {expected}")
    check(lines[0].startswith("Selection"), f"bad Raven header {lines[0]!r}")
    return {"wav": str(wav), "rows": len(rows)}


# -- phase 4 ------------------------------------------------------------------


def phase_served(out: Path, wav: str, max_batch: int = 256,
                 timeout_s: float = 90.0, model_id: str = "BirdNET_V2.4"
                 ) -> dict:
    import jax

    from birdnet_go_tpu.app import Application
    from birdnet_go_tpu.config.settings import ModelSettings, Settings

    db = out / "served.db"
    db.unlink(missing_ok=True)
    s = Settings()
    s.webserver.enabled = False          # aiohttp is optional
    s.imageprovider.enabled = False      # no outside hosts
    s.models = [ModelSettings(model_id=model_id, threshold=0.01)]
    s.database.path = str(db)
    s.export.enabled = False             # clip PNGs need Pillow
    s.realtime.max_batch = max_batch
    s.realtime.sources = [
        {"type": "tone", "id": "tone0", "freq": 1500, "speed": 2.0},
        {"type": "tone", "id": "tone1", "freq": 4200, "pulse": 3.0,
         "speed": 2.0},
        {"type": "file", "id": "file0", "path": wav, "speed": 2.0},
    ]
    app = Application(s)
    app.setup()
    batcher = app.device_loop.batchers[model_id]
    t0 = time.perf_counter()
    try:
        app.start(warmup=True)
        start_s = time.perf_counter() - t0
        check(batcher.warmup_seconds is not None,
              "warmup did not compile the step")
        deadline = time.monotonic() + timeout_s
        while (time.monotonic() < deadline
               and app.datastore.count_detections() == 0):
            time.sleep(0.5)
    finally:
        app.stop()
    with contextlib.closing(sqlite3.connect(str(db))) as conn:
        (n_det,) = conn.execute("SELECT COUNT(*) FROM detections").fetchone()
    stats = batcher.stats
    peak = jax.devices()[0].memory_stats() or {}
    say("served", warmup_compile_s=f"{batcher.warmup_seconds:.2f}",
        start_s=f"{start_s:.2f}", batches_dispatched=stats.batches_dispatched,
        windows_harvested=stats.windows_processed,
        sqlite_detections=n_det,
        peak_bytes_in_use=peak.get("peak_bytes_in_use", "n/a"))
    check(stats.windows_processed > 0, "no windows harvested")
    check(n_det > 0, "no detections in the SQLite datastore")
    return {"detections": int(n_det),
            "windows": stats.windows_processed,
            "warmup_s": batcher.warmup_seconds}


# -- phase 5 ------------------------------------------------------------------


def phase_timings(model, params, batches=(256, 1024), iters: int = 20,
                  card: str = "", peak_tflops: float | None = None) -> dict:
    """Production step and front end alone (both DFT routes) per batch."""
    import jax

    import bench

    out = {}
    for batch in batches:
        r = bench.measure_step(model, params, batch, iters=iters)
        mem = r.pop("memory")
        pcm = jax.device_put(
            bench.seeded_pcm(batch, model.spec.clip_samples))
        fe = {}
        for route, use_matmul in ROUTES:
            cfg = dataclasses.replace(model.mel, use_matmul_fft=use_matmul)
            fn = bench.frontend_fn(cfg)
            times = bench.time_calls(fn, pcm, iters=iters)
            fe[route] = statistics.median(times) * 1e3
        step_ms = r["step_ms_p50"]
        say("timings", card=repr(card), batch=batch,
            step_ms_p50=f"{step_ms:.3f}",
            step_ms_min=f"{r['step_ms_min']:.3f}",
            step_ms_max=f"{r['step_ms_max']:.3f}",
            windows_per_s=f"{r['windows_per_s']:.1f}",
            compile_s=f"{r['compile_s']:.2f}",
            gflop_per_window=f"{r['flops_per_window'] / 1e9:.4f}",
            achieved_tflops=f"{r['achieved_tflops']:.2f}",
            share_of_bf16_peak=(f"{r['achieved_tflops'] / peak_tflops:.4f}"
                                if peak_tflops else "n/a"))
        for route, ms in fe.items():
            say("timings", card=repr(card), batch=batch,
                frontend_route=route, frontend_ms_p50=f"{ms:.3f}",
                share_of_step=f"{ms / step_ms:.3f}")
        if mem is not None:
            say("timings", card=repr(card), batch=batch,
                temp_bytes=mem.temp_size_in_bytes,
                argument_bytes=mem.argument_size_in_bytes,
                output_bytes=mem.output_size_in_bytes,
                generated_code_bytes=mem.generated_code_size_in_bytes)
        check(np.isfinite(step_ms) and step_ms > 0, "bad step time")
        out[batch] = {"step": r, "frontend_ms": fe}
    return out


# -- four cards ---------------------------------------------------------------


def phase_four_cards(model, params, batch: int, seed: int,
                     n_devices: int = 4) -> dict:
    """ShardedClassifier under ModelBatcher/DeviceLoop on the default mesh
    against the one-card ModelBatcher step on the same int16 batch."""
    import jax

    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.parallel.mesh import make_mesh
    from birdnet_go_tpu.parallel.serving import ShardedClassifier
    from birdnet_go_tpu.scheduler.loop import DeviceLoop, ModelBatcher

    check(len(jax.devices()) >= n_devices,
          f"{n_devices} devices needed, {len(jax.devices())} visible")
    spec = model.spec
    pcm = make_windows(batch, spec.clip_samples, spec.sample_rate, seed)

    def run(clf):
        got = {}
        b = ModelBatcher(clf, max_batch=batch,
                         on_result=lambda w, v, i: got.__setitem__(
                             w.source_id, (np.array(v), np.array(i))))
        loop = DeviceLoop()
        loop.add_batcher(b)
        fed = [(spec.model_id, pcm[j], f"s{j}", 0.0) for j in range(batch)]
        loop.add_provider(lambda: [fed.pop() for _ in range(len(fed))])
        t0 = time.perf_counter()
        b.warmup()
        warm = time.perf_counter() - t0
        loop.run_tick()
        loop.drain()
        check(len(got) == batch, f"{len(got)} of {batch} windows harvested")
        vals = np.stack([got[f"s{j}"][0] for j in range(batch)])
        idx = np.stack([got[f"s{j}"][1] for j in range(batch)])
        return vals, idx, warm

    mesh = make_mesh(n_devices)
    sharded = ShardedClassifier(model, params, mesh=mesh)
    v4, i4, warm4 = run(sharded)
    single = JaxClassifier(model, jax.device_put(params, jax.devices()[0]))
    v1, i1, warm1 = run(single)
    k = i1.shape[1]
    delta = float(np.max(np.abs(v4 - v1)))
    overlap = float(np.mean([len(set(i4[r]) & set(i1[r])) / k
                             for r in range(batch)]))
    top1 = float(np.mean(i4[:, 0] == i1[:, 0]))
    say("four_cards", mesh=repr(dict(mesh.shape)), batch=batch,
        max_conf_delta=f"{delta:.4e}", topk_overlap=f"{overlap:.4f}",
        top1_agree=f"{top1:.4f}", warmup_sharded_s=f"{warm4:.2f}",
        warmup_single_s=f"{warm1:.2f}")
    # Same parameters, same windows: only reduction order and per-device
    # conv algorithm choice differ, so the bf16 step agrees within the
    # reference gate.
    check(delta < TOL_CONF, f"sharded vs one-card delta {delta:.4f}")
    check(overlap >= MIN_TOP10_OVERLAP, f"top-K overlap {overlap:.3f}")
    return {"max_conf_delta": delta, "topk_overlap": overlap}


# -- main ---------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=DEFAULT_OUT)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card sharded serving phase")
    args = p.parse_args(argv)

    dev = phase_device()
    import jax
    import jax.numpy as jnp

    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
    from birdnet_go_tpu.utils.jaxcache import enable_compile_cache

    say("device", compile_cache=enable_compile_cache())
    import bench

    card = bench.card_name_and_power()
    model = BirdNETv24()
    params = model.init(jax.random.PRNGKey(args.seed))
    if args.four_cards:
        check(len(jax.devices()) == 4,
              f"--four-cards needs 4 devices, found {len(jax.devices())}")
        phase_four_cards(model, params, batch=256, seed=args.seed)
    else:
        phase_reference(model, BirdNETv24(compute_dtype=jnp.float32), params,
                        batch=16, seed=args.seed)
        off = phase_offline(args.out, args.seed)
        phase_served(args.out, off["wav"])
        phase_timings(model, params, card=card,
                      peak_tflops=bench.peak_for(dev.device_kind)[0])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

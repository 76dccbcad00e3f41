"""Device-step timing of the realtime BirdNET v2.4 path on one GPU.

Times the production realtime step — the jitted step of
`scheduler.loop.ModelBatcher`: int16 PCM → float32 → mel front end →
EfficientNet-B0 → sigmoid → top-10 — at the serving megabatch (256) and a
throughput megabatch (1024), with seeded random weights at full width
(144,000-sample windows, 6,522 classes). Every timed call ends in
`block_until_ready`, so a time is the device's, not the enqueue's.

A realtime 48 kHz stream yields one 3 s window every 1.5 s (50 % overlap,
reference internal/classifier/model.go:40-54), so

    streams = windows_per_second × 1.5

The script refuses to run without a GPU: a CPU time is not a device time.

Usage: python bench.py   → one JSON line on stdout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

WINDOW_HOP_SECONDS = 1.5        # 3 s window, 50% overlap
BATCHES = (256, 1024)           # serving megabatch, throughput megabatch
ITERS = 20

# Dense peaks by `device_kind` (NVIDIA H100 data sheet, no sparsity):
# (bf16 tensor-core TFLOP/s, device-memory TB/s). The SXM part assumes
# its full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3.35),     # SXM5
    "NVIDIA H100 PCIe": (756.0, 2.0),
    "NVIDIA H100 NVL": (835.0, 3.9),
}


def peak_for(device_kind: str) -> tuple[float, float]:
    """(bf16 TFLOP/s, TB/s) for a device kind; unknown kinds are an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peak for device kind {device_kind!r}; "
                       "add it to bench.PEAKS with its source") from None


def require_gpu():
    """The first device, if it is a GPU; otherwise exit non-zero."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"a GPU is required; JAX found {dev.platform!r} "
                         f"({dev.device_kind}) — refusing to report CPU "
                         "times as device times")
    return dev


def card_name_and_power() -> str:
    """`name, power.limit` of the card(s) as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()


def seeded_pcm(batch: int, samples: int, seed: int = 0) -> np.ndarray:
    """Seeded int16 noise at about -26 dBFS."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, samples)) * 0.05 * 32767
            ).astype(np.int16)


def time_calls(fn, *args, iters: int = ITERS) -> list[float]:
    """Seconds per call of an already-compiled `fn`, each call ending in
    block_until_ready (one untimed call first)."""
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def compile_step(model, params, batch: int, seed: int = 0):
    """AOT-compile the ModelBatcher step at `batch`.

    Returns (compiled, dynamic args with the PCM on device, compile s)."""
    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    clf = JaxClassifier(model, params)
    b = ModelBatcher(clf, max_batch=batch)
    pcm = jax.device_put(seeded_pcm(batch, model.spec.clip_samples, seed))
    sens = jnp.float32(1.0)
    t0 = time.perf_counter()
    compiled = b._step.lower(clf.params, pcm, sens, b.top_k, None).compile()
    compile_s = time.perf_counter() - t0
    return compiled, (clf.params, pcm, sens, None), compile_s


def shape_flops(fn, *args, static_argnums=()) -> float:
    """FLOPs of `fn(*args)` counted from the shapes in its jaxpr: 2 × the
    multiply-adds of every dot_general and conv_general_dilated, nested
    jaxprs included (loop bodies once). Elementwise work, FFTs and
    reductions are not counted. XLA's own cost analysis cannot be the
    numerator on the GPU: it leaves out convolutions handed to cuDNN."""
    closed = jax.make_jaxpr(fn, static_argnums=static_argnums)(*args)
    return _jaxpr_flops(closed.jaxpr)


def _jaxpr_flops(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "conv_general_dilated"):
            lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
            out = eqn.outvars[0].aval.shape
            if name == "dot_general":
                (lc, _), _ = eqn.params["dimension_numbers"]
                macs_per_out = np.prod([lhs[d] for d in lc])
            else:
                rhs_spec = eqn.params["dimension_numbers"].rhs_spec
                macs_per_out = np.prod([rhs[d] for d in rhs_spec[1:]])
            total += 2.0 * float(np.prod(out)) * float(macs_per_out)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    total += _jaxpr_flops(sub)
    return total


def frontend_fn(mel_cfg):
    """Jitted front end alone: int16 PCM → float32 → mel spectrogram."""
    from birdnet_go_tpu.ops.melspec import melspec
    from birdnet_go_tpu.ops.pcm import pcm16_to_float32

    return jax.jit(lambda pcm: melspec(pcm16_to_float32(pcm), mel_cfg))


def step_flops_per_window(model, params, batch: int) -> float:
    """Shape-counted FLOPs of one window of the production step."""
    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    b = ModelBatcher(JaxClassifier(model, params), max_batch=batch)
    pcm = jax.ShapeDtypeStruct((batch, model.spec.clip_samples), jnp.int16)
    return shape_flops(b._step, params, pcm, jnp.float32(1.0), b.top_k,
                       None, static_argnums=(3,)) / batch


def measure_step(model, params, batch: int, iters: int = ITERS) -> dict:
    """Compile and time the production step at one batch size."""
    compiled, args, compile_s = compile_step(model, params, batch)
    times = time_calls(compiled, *args, iters=iters)
    p50 = statistics.median(times)
    flops = step_flops_per_window(model, params, batch)
    return {
        "batch": batch,
        "compile_s": compile_s,
        "step_ms_p50": p50 * 1e3,
        "step_ms_min": min(times) * 1e3,
        "step_ms_max": max(times) * 1e3,
        "windows_per_s": batch / p50,
        "streams": batch / p50 * WINDOW_HOP_SECONDS,
        "flops_per_window": flops,
        "achieved_tflops": flops * batch / p50 / 1e12,
        "memory": compiled.memory_analysis(),
    }


def main() -> int:
    dev = require_gpu()
    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
    from birdnet_go_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    peak_tflops, peak_tbs = peak_for(dev.device_kind)
    model = BirdNETv24()
    params = model.init(jax.random.PRNGKey(0))
    rows = []
    for batch in BATCHES:
        r = measure_step(model, params, batch)
        mem = r.pop("memory")
        r["temp_bytes"] = getattr(mem, "temp_size_in_bytes", None)
        r["share_of_bf16_peak"] = r["achieved_tflops"] / peak_tflops
        rows.append(r)
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_name_and_power(),
        "peak_bf16_tflops": peak_tflops,
        "peak_tb_per_s": peak_tbs,
        "model": "BirdNET_V2.4 (seeded random weights)",
        "steps": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

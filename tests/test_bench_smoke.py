"""bench.py below its device check, at toy scale on the CPU.

bench.main() refuses a CPU-only host, so these tests drive its measurement
functions directly: AOT compile of the production ModelBatcher step, timed
calls ending in block_until_ready, XLA cost analysis, and the peak table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def tiny_birdnet():
    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
    from birdnet_go_tpu.models.efficientnet import (
        BlockSpec,
        EfficientNetConfig,
    )
    from birdnet_go_tpu.ops.melspec import MelConfig

    m = BirdNETv24(
        num_species=16,
        mel=MelConfig(sample_rate=48000, n_fft=256, hop=9000, n_mels=16),
        compute_dtype=jnp.float32)
    m.net = EfficientNetConfig(
        blocks=(BlockSpec(1, 8, 3, 1, 1), BlockSpec(4, 16, 3, 2, 1)),
        embedding_dim=16, num_classes=16)
    return m


def test_bench_main_tiny():
    import bench

    m = tiny_birdnet()
    params = m.init(jax.random.PRNGKey(0))
    r = bench.measure_step(m, params, batch=2, iters=2)
    assert r["batch"] == 2 and r["compile_s"] > 0
    assert 0 < r["step_ms_min"] <= r["step_ms_p50"] <= r["step_ms_max"]
    assert r["windows_per_s"] == pytest.approx(2 / (r["step_ms_p50"] / 1e3))
    assert r["streams"] == pytest.approx(r["windows_per_s"] * 1.5)
    assert r["flops_per_window"] > 0
    assert r["achieved_tflops"] == pytest.approx(
        r["flops_per_window"] * r["windows_per_s"] / 1e12)
    assert r["memory"] is not None


def test_bench_step_is_the_model_batcher_step():
    """The timed executable computes what ModelBatcher serves."""
    import bench
    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    m = tiny_birdnet()
    params = m.init(jax.random.PRNGKey(0))
    compiled, args, _ = bench.compile_step(m, params, batch=2)
    vals, idx, _cv = compiled(*args)
    b = ModelBatcher(JaxClassifier(m, params), max_batch=2)
    got = []
    b.on_result = lambda w, v, i: got.append((v, i))
    pcm = np.asarray(args[1])
    for row in pcm:
        b.offer(row, "s", 0.0)
    b.dispatch()
    b.harvest_all()
    np.testing.assert_allclose(np.stack([v for v, _ in got]),
                               np.asarray(vals), rtol=1e-6)
    np.testing.assert_array_equal(np.stack([i for _, i in got]),
                                  np.asarray(idx))


def test_bench_frontend_fn_matches_melspec():
    import bench
    from birdnet_go_tpu.ops.melspec import melspec

    cfg = tiny_birdnet().mel
    pcm = bench.seeded_pcm(2, 48000)
    got = np.asarray(bench.frontend_fn(cfg)(jnp.asarray(pcm)))
    want = np.asarray(melspec(jnp.asarray(pcm / 32768.0, jnp.float32), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_shape_flops_counts_dots_and_convs():
    """2 × multiply-adds from shapes: a dense layer, a 3×3 conv and a
    depthwise conv, the last inside a nested jit."""
    import bench

    x = jnp.zeros((4, 10, 12, 8), jnp.float32)
    w = jnp.zeros((3, 3, 8, 16), jnp.float32)
    wd = jnp.zeros((3, 3, 1, 16), jnp.float32)
    dense = jnp.zeros((16, 5), jnp.float32)
    dn = ("NHWC", "HWIO", "NHWC")

    def f(x, w, wd, dense):
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                         dimension_numbers=dn)
        y = jax.jit(lambda y: jax.lax.conv_general_dilated(
            y, wd, (2, 2), "SAME", dimension_numbers=dn,
            feature_group_count=16))(y)
        return y.mean(axis=(1, 2)) @ dense

    want = (2 * 4 * 10 * 12 * 16 * 8 * 9       # conv
            + 2 * 4 * 5 * 6 * 16 * 1 * 9        # depthwise, stride 2
            + 2 * 4 * 5 * 16)                   # dense
    assert bench.shape_flops(f, x, w, wd, dense) == want


def test_step_flops_per_window_is_batch_independent():
    import bench

    m = tiny_birdnet()
    params = m.init(jax.random.PRNGKey(0))
    a = bench.step_flops_per_window(m, params, 2)
    assert a > 0
    assert bench.step_flops_per_window(m, params, 4) == pytest.approx(a)


@pytest.mark.parametrize("kind,tflops,tbs", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3.35),
    ("NVIDIA H100 PCIe", 756.0, 2.0),
    ("NVIDIA H100 NVL", 835.0, 3.9),
])
def test_peak_table_known_kinds(kind, tflops, tbs):
    import bench

    assert bench.peak_for(kind) == (tflops, tbs)


def test_peak_table_unknown_kind_raises():
    import bench

    with pytest.raises(KeyError, match="no published peak"):
        bench.peak_for("cpu")


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit, match="GPU is required"):
        bench.require_gpu()
    with pytest.raises(SystemExit):
        bench.main()

"""The one realtime device step and its front end, per registry family.

- ModelBatcher's step (int16 PCM → float32 on device → `model.apply` →
  sigmoid → top-K) equals `apply(pcm / 32768)` for every mel family;
- both XLA DFT routes of the mel front end agree with a float64 numpy rFFT
  at each family's real mel widths (chip_smoke.py runs the same check on
  the GPU);
- a mesh-sharded classifier gets its megabatch placed with the batch
  sharding, and a batch that does not divide over the data axis is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

MEL_FAMILIES = ["BirdNET_V2.4", "BirdNET_V3.0", "Perch_V2", "BattyBirdNET",
                "BSG"]


def _family(model_id: str, n: int = 12):
    """The registry family with its real mel front end and a tiny
    backbone (full-width backbones are for the GPU)."""
    from birdnet_go_tpu.inference.loader import build_model
    from birdnet_go_tpu.models.efficientnet import (
        BlockSpec,
        EfficientNetConfig,
    )

    m = build_model(model_id)
    m.num_species = n
    m.compute_dtype = jnp.float32
    m.net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                               embedding_dim=16, num_classes=n)
    return m


def _pcm(batch: int, samples: int, seed: int) -> np.ndarray:
    import chip_smoke

    return chip_smoke.make_windows(batch, samples, 48000, seed)


@pytest.mark.parametrize("model_id", MEL_FAMILIES)
def test_int16_step_equals_apply(model_id):
    from birdnet_go_tpu.inference.backend import JaxClassifier
    from birdnet_go_tpu.ops.postprocess import (
        sigmoid_confidence,
        top_k_results,
    )
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    m = _family(model_id)
    params = m.init(jax.random.PRNGKey(1))
    pcm = _pcm(2, m.spec.clip_samples, 3)
    got = []
    b = ModelBatcher(JaxClassifier(m, params), max_batch=2, top_k=5,
                     on_result=lambda w, v, i: got.append((v, i)))
    for row in pcm:
        b.offer(row, "s", 0.0)
    b.dispatch()
    b.harvest_all()
    out = m.apply(params, jnp.asarray(pcm.astype(np.float32) / 32768.0))
    vals, idx = top_k_results(sigmoid_confidence(out["logits"], 1.0), 5)
    np.testing.assert_allclose(np.stack([v for v, _ in got]),
                               np.asarray(vals), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.stack([i for _, i in got]),
                                  np.asarray(idx))


@pytest.mark.parametrize("route", ["matmul", "rfft"])
@pytest.mark.parametrize("model_id", MEL_FAMILIES)
def test_frontend_route_matches_float64_reference(model_id, route):
    import chip_smoke

    m = _family(model_id)
    pcm = _pcm(2, m.spec.clip_samples, 4)
    routes = [r for r in chip_smoke.ROUTES if r[0] == route]
    err = chip_smoke.check_frontend(m.mel, pcm, routes=routes)[route]
    assert err["spectrum"] <= chip_smoke.TOL_SPECTRUM
    assert err["mel"] <= chip_smoke.TOL_MEL


def test_frontend_check_catches_a_wrong_spectrum(monkeypatch):
    """The reference comparison fails when the two disagree by 1 %."""
    import chip_smoke

    m = _family("BirdNET_V2.4")
    pcm = _pcm(1, m.spec.clip_samples, 5)
    orig = chip_smoke.reference_spectrum
    monkeypatch.setattr(chip_smoke, "reference_spectrum",
                        lambda p, c: orig(p, c) * 1.01)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_frontend(m.mel, pcm, routes=[("rfft", False)])


def test_sharded_batcher_places_megabatch_on_data_axis():
    from birdnet_go_tpu.parallel.mesh import make_mesh
    from birdnet_go_tpu.parallel.serving import ShardedClassifier
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    m = _family("BirdNET_V2.4")
    params = m.init(jax.random.PRNGKey(0))
    mesh = make_mesh(4)
    b = ModelBatcher(ShardedClassifier(m, params, mesh=mesh), max_batch=4)
    placed = b._put(b._staged)
    assert placed.sharding == b.classifier.input_sharding
    assert len({s.device for s in placed.addressable_shards}) == 4
    assert placed.addressable_shards[0].data.shape[0] == 4 // mesh.shape[
        "data"]


def test_sharded_batcher_refuses_indivisible_batch():
    from birdnet_go_tpu.parallel.mesh import make_mesh
    from birdnet_go_tpu.parallel.serving import ShardedClassifier
    from birdnet_go_tpu.scheduler.loop import ModelBatcher

    m = _family("BirdNET_V2.4")
    params = m.init(jax.random.PRNGKey(0))
    clf = ShardedClassifier(m, params, mesh=make_mesh(4))
    with pytest.raises(ValueError):
        ModelBatcher(clf, max_batch=3)

"""Forward-shape and numeric-sanity tests for the model families.

Full-size models are slow on the CPU test platform, so these use shrunken
block schedules / species counts; full-size compile is exercised on the GPU
by chip_smoke.py and bench.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from birdnet_go_tpu.models.bat import BatClassifier
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu.models.efficientnet import BlockSpec, EfficientNetConfig
from birdnet_go_tpu.models.geomodel import Geomodel, GeomodelConfig, birdnet_week
from birdnet_go_tpu.models.registry import (
    BIRDNET_V24,
    BAT,
    PERCH_V2,
    get_model_spec,
)
from birdnet_go_tpu.ops.melspec import MelConfig

TINY_BLOCKS = (
    BlockSpec(1, 8, 3, 2, 1),
    BlockSpec(4, 16, 3, 2, 1),
    BlockSpec(4, 24, 5, 2, 1),
)
TINY_MEL = MelConfig(sample_rate=48000, n_fft=512, hop=2048, n_mels=32)


def _tiny_birdnet(num_species=37):
    m = BirdNETv24(num_species=num_species, mel=TINY_MEL,
                   compute_dtype=jnp.float32)
    m.net = EfficientNetConfig(blocks=TINY_BLOCKS, embedding_dim=64,
                               num_classes=num_species)
    return m


def test_registry_specs():
    assert BIRDNET_V24.clip_samples == 144000
    assert BIRDNET_V24.clip_size_bytes == 288000
    assert BIRDNET_V24.buffer_dimensions() == (144000, 144000)
    assert BIRDNET_V24.buffer_interval_seconds == 1.5
    assert BAT.effective_sample_rate == 256000
    assert PERCH_V2.num_species == 14795
    assert get_model_spec("BirdNET_V2.4") is BIRDNET_V24
    with pytest.raises(KeyError):
        get_model_spec("nope")


def test_birdnet_v24_forward_tiny(rng_key):
    m = _tiny_birdnet()
    params = m.init(rng_key)
    pcm = jax.random.normal(rng_key, (2, 144000), jnp.float32) * 0.1
    out = jax.jit(m.apply)(params, pcm)
    assert out["logits"].shape == (2, 37)
    assert out["embedding"].shape == (2, 64)
    assert np.isfinite(np.asarray(out["logits"])).all()


def test_birdnet_v24_jit_deterministic(rng_key):
    m = _tiny_birdnet()
    params = m.init(rng_key)
    pcm = jax.random.normal(rng_key, (1, 144000), jnp.float32) * 0.1
    a = np.asarray(jax.jit(m.apply)(params, pcm)["logits"])
    b = np.asarray(jax.jit(m.apply)(params, pcm)["logits"])
    np.testing.assert_array_equal(a, b)


def test_bat_two_stage_tiny(rng_key):
    m = BatClassifier(num_species=12, mel=TINY_MEL, compute_dtype=jnp.float32)
    m.net = EfficientNetConfig(blocks=TINY_BLOCKS, embedding_dim=32,
                               num_classes=12)
    params = m.init(rng_key)
    pcm = jax.random.normal(rng_key, (2, 144000), jnp.float32) * 0.1
    out = jax.jit(m.apply)(params, pcm)
    assert out["logits"].shape == (2, 12)
    assert out["embedding"].shape == (2, 32)


def test_geomodel_scores_and_week(rng_key):
    import datetime

    assert birdnet_week(datetime.date(2026, 1, 1)) == 1
    assert birdnet_week(datetime.date(2026, 1, 31)) == 4   # capped at 4/month
    assert birdnet_week(datetime.date(2026, 12, 25)) == 48

    g = Geomodel(GeomodelConfig(num_species=50, hidden=(32,)))
    params = g.init(rng_key)
    coords = jnp.asarray([[60.17, 24.94, 23.0], [60.17, 24.94, -1.0]])
    scores = jax.jit(g.apply)(params, coords)
    assert scores.shape == (2, 50)
    s = np.asarray(scores)
    assert ((s >= 0) & (s <= 1)).all()
    # week on vs off must differ (seasonality is live)
    assert not np.allclose(s[0], s[1])


def test_geomodel_heatmap_grid_vmap(rng_key):
    g = Geomodel(GeomodelConfig(num_species=8, hidden=(16,)))
    params = g.init(rng_key)
    lats = jnp.linspace(-60, 60, 5)
    lons = jnp.linspace(-150, 150, 7)
    grid = jnp.stack(jnp.meshgrid(lats, lons, indexing="ij"), axis=-1)
    coords = jnp.concatenate(
        [grid, jnp.full((5, 7, 1), 20.0)], axis=-1)
    scores = jax.jit(g.apply)(params, coords)
    assert scores.shape == (5, 7, 8)


def test_bsg_finland_family():
    """BSG Finland v4.4 (model_registry.go RegistryIDBSG): 48 kHz / 3 s
    regional classifier, loadable by family id, batcher-compatible."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from birdnet_go_tpu.inference.loader import build_model
    from birdnet_go_tpu.models.efficientnet import (
        BlockSpec,
        EfficientNetConfig,
    )
    from birdnet_go_tpu.models.registry import MODEL_REGISTRY
    from birdnet_go_tpu.ops.melspec import MelConfig

    assert "BSG" in MODEL_REGISTRY
    spec = MODEL_REGISTRY["BSG"]
    assert spec.sample_rate == 48000 and spec.clip_seconds == 3.0

    m = build_model("BSG", num_species=12,
                    mel=MelConfig(sample_rate=48000, n_fft=256, hop=8192,
                                  n_mels=16),
                    compute_dtype=jnp.float32)
    m.net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                               embedding_dim=16, num_classes=12)
    params = m.init(jax.random.PRNGKey(0))
    pcm = jnp.zeros((2, 144000), jnp.float32)
    out = m.apply(params, pcm)
    assert out["logits"].shape == (2, 12)
    assert np.isfinite(np.asarray(out["logits"])).all()

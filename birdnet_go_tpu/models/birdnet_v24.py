"""BirdNET v2.4: 48 kHz / 3 s PCM → 6,522 species logits.

The reference loads this as an embedded TFLite flatbuffer and feeds raw
float32 PCM (internal/classifier/birdnet.go:71-121, analyze.go:25-110). Here
the model is a native JAX graph: mel front end (ops.melspec) +
EfficientNet-B0 class CNN; parameters come from the
TFLite importer (birdnet_go_tpu.inference.tflite_import) or fresh
initialization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from birdnet_go_tpu.models import registry
from birdnet_go_tpu.models.base import MelCnnModel
from birdnet_go_tpu.models.efficientnet import (
    B0_BLOCKS,
    EfficientNetConfig,
    init_efficientnet,
)
from birdnet_go_tpu.ops.melspec import MelConfig


class BirdNETv24(MelCnnModel):
    """Functional model wrapper: `init(key) -> params`, `apply(params, pcm)`.

    `apply` takes float32 PCM [B, 144000] in [-1, 1] and returns
    {"logits": [B, 6522], "embedding": [B, 1280]}. The realtime step
    (scheduler.loop.ModelBatcher) converts int16 PCM on device and calls
    `apply`.
    """

    spec = registry.BIRDNET_V24

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype=jnp.bfloat16):
        self.num_species = num_species or self.spec.num_species
        self.mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=512,
            n_mels=96, fmin=0.0, fmax=15000.0, mag_scale="nonlinear")
        self.net = EfficientNetConfig(
            blocks=B0_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=self.num_species)
        self.compute_dtype = compute_dtype

    def init(self, key: jax.Array):
        return init_efficientnet(key, self.net)

"""BattyBirdNET two-stage bat classifier.

Reference (internal/classifier/bat_onnx.go:19-120,
doc/wiki/detection-pipeline.md:103-117): a BirdNET v2.4 ONNX embedding
extractor (1024-dim GLOBAL_AVG_POOL output) feeds a regional bat classifier
head. Ultrasonic audio captured at 256 kHz is fed *unresampled* as if it were
48 kHz — the "slow-down trick" (~5.3×) that shifts bat calls into the
audible band the embedding model was trained on.

Native JAX: the embedding stage shares the BirdNET v2.4 backbone (smaller
1024-dim embedding head) and the regional head is a dense layer — both in
one jitted graph, so the two "stages" of the reference collapse into a
single device step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from birdnet_go_tpu.models import layers as L
from birdnet_go_tpu.models import registry
from birdnet_go_tpu.models.base import MelCnnModel
from birdnet_go_tpu.models.efficientnet import (
    B0_BLOCKS,
    EfficientNetConfig,
    apply_efficientnet,
    init_efficientnet,
)
from birdnet_go_tpu.ops.melspec import MelConfig, melspec


class BatClassifier(MelCnnModel):
    spec = registry.BAT

    def __init__(self, num_species: int | None = None,
                 mel: MelConfig | None = None,
                 compute_dtype=jnp.bfloat16):
        self.num_species = num_species or self.spec.num_species
        # Mel front end in "48 kHz coordinates": the 256 kHz raw window is
        # 3 s × 48000 samples *nominal* (the slow-down trick means actual
        # wall-clock coverage is 3 s × 48000/256000 ≈ 0.5625 s of ultrasound).
        self.mel = mel or MelConfig(
            sample_rate=self.spec.sample_rate, n_fft=2048, hop=512,
            n_mels=96, fmin=0.0, fmax=15000.0, mag_scale="nonlinear")
        self.net = EfficientNetConfig(
            blocks=B0_BLOCKS, embedding_dim=self.spec.embedding_dim,
            num_classes=self.num_species)
        self.compute_dtype = compute_dtype

    def init(self, key: jax.Array):
        k1, k2 = jax.random.split(key)
        backbone = init_efficientnet(k1, self.net)
        # The backbone's own classifier is unused: the regional head replaces
        # it (two-stage structure of the reference, fused into one graph).
        head = L.init_dense(k2, self.net.embedding_dim, self.num_species)
        return {"backbone": backbone, "head": head}

    def features(self, pcm: jnp.ndarray) -> jnp.ndarray:
        return melspec(pcm, self.mel)[..., None]

    def embed(self, params, pcm: jnp.ndarray, train: bool = False):
        feats = self.features(pcm).astype(self.compute_dtype)
        out = apply_efficientnet(params["backbone"], feats, self.net,
                                 train=train, compute_dtype=self.compute_dtype)
        return out["embedding"]

    def apply(self, params, pcm: jnp.ndarray, train: bool = False):
        emb = self.embed(params, pcm, train)
        logits = L.apply_dense(params["head"], emb.astype(self.compute_dtype),
                               self.compute_dtype)
        return {"logits": logits.astype(jnp.float32), "embedding": emb}

    def __call__(self, params, pcm, train: bool = False):
        return self.apply(params, pcm, train)

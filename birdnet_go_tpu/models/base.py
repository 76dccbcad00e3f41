"""Shared base for the mel+EfficientNet model families."""

from __future__ import annotations

import jax.numpy as jnp

from birdnet_go_tpu.models.efficientnet import apply_efficientnet
from birdnet_go_tpu.ops.melspec import melspec


class MelCnnModel:
    """init/apply over a mel front end + EfficientNet backbone.

    Subclasses set: spec, num_species, mel (MelConfig), net
    (EfficientNetConfig), compute_dtype.
    """

    # store inter-block activations as int8 in device memory (lossy,
    # parity-gated by tests/test_quantized.py; off by default)
    act_int8: bool = False

    def features(self, pcm: jnp.ndarray) -> jnp.ndarray:
        """float32 PCM [B, T] → mel features NHWC [B, frames, mels, 1]."""
        return melspec(pcm, self.mel)[..., None]

    def apply(self, params, pcm: jnp.ndarray, train: bool = False):
        feats = self.features(pcm).astype(self.compute_dtype)
        return apply_efficientnet(params, feats, self.net, train=train,
                                  compute_dtype=self.compute_dtype,
                                  act_int8=self.act_int8)

    def __call__(self, params, pcm, train: bool = False):
        return self.apply(params, pcm, train)

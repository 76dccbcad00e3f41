"""Prediction post-processing: sigmoid-with-sensitivity, top-K, range masking.

Reference contracts:
- sigmoid: 1/(1+exp(-sensitivity·logit)), sensitivity default 1.0 in [0, 1.5]
  (internal/classifier/analyze.go:115 customSigmoid; conf/defaults.go:76);
- top-K: K=10 results kept per window (analyze.go:231 getTopKResults);
- range filter: per-species occurrence gating applied before thresholds
  (internal/analysis/processor/processor.go:1011).

All ops are jittable and batched — the 6,523-wide (or 14,795-wide Perch)
confidence vector is tiny; the win is doing sigmoid+top-K on device so only
[B, K] indices/scores cross PCIe back to the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sigmoid_confidence(logits: jnp.ndarray, sensitivity: float | jnp.ndarray = 1.0
                       ) -> jnp.ndarray:
    """Confidence = sigmoid(sensitivity · logit), elementwise."""
    return jax.nn.sigmoid(jnp.asarray(sensitivity, logits.dtype) * logits)


def top_k_results(confidence: jnp.ndarray, k: int = 10
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[..., S] confidences → (values [..., k], indices [..., k]), sorted desc.

    Mirrors getTopKResults (quickselect K=10 in the reference) —
    jax.lax.top_k over the species axis.
    """
    return jax.lax.top_k(confidence, k)


def apply_range_mask(confidence: jnp.ndarray, included: jnp.ndarray
                     ) -> jnp.ndarray:
    """Zero the confidence of species not in the included-species set.

    `included` is a [S] float32/bool mask built from the range filter
    (reference keeps a set of scientific names; on device it is a mask so
    masking fuses into the sigmoid epilogue).
    """
    return confidence * included.astype(confidence.dtype)


def occurrence_mask(scores: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Range-filter occurrence scores → inclusion mask (score ≥ threshold).

    Reference threshold default 0.01 (config) / 0.03 (ONNX constant) —
    conf/defaults.go:91, internal/inference/onnx/rangefilter.go:11.
    """
    return (scores >= threshold).astype(jnp.float32)

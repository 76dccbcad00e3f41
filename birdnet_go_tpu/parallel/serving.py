"""Multi-chip serving: shard the inference megabatch across a device mesh.

Single-chip serving needs no collectives (SURVEY.md §2.7 — the reference's
stream-level parallelism maps to the batch dimension). Beyond one chip,
the same jitted step runs SPMD: the [B, clip] megabatch is sharded over
the "data" axis, classifier-head params over "model" (tensor parallel for
the 14,795-wide Perch head), everything else replicated; XLA inserts the
collectives.

`ShardedClassifier` wraps a model the same way JaxClassifier does, so the
scheduler's ModelBatcher works unchanged — only params/input placement
differs: ModelBatcher places each megabatch with `input_sharding`.
"""

from __future__ import annotations

import logging
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from birdnet_go_tpu.parallel.mesh import (
    batch_sharding,
    make_mesh,
    shard_params,
)

log = logging.getLogger("birdnet_tpu.parallel")


class ShardedClassifier:
    """Drop-in for JaxClassifier with mesh-sharded params and inputs."""

    def __init__(self, model: Any, params: Any, mesh: Mesh | None = None,
                 range_mask: np.ndarray | None = None):
        import functools

        from birdnet_go_tpu.ops.postprocess import (
            sigmoid_confidence,
            top_k_results,
        )

        self.model = model
        self.mesh = mesh or make_mesh()
        self.model_id = model.spec.model_id
        self.num_species = model.num_species
        self.params = shard_params(params, self.mesh)
        self.input_sharding = batch_sharding(self.mesh)
        self._replicated = NamedSharding(self.mesh, P())
        self._range_mask = (
            jax.device_put(jnp.asarray(range_mask, jnp.float32),
                           self._replicated)
            if range_mask is not None else None)
        self._data_parallel = self.mesh.shape["data"]

        @functools.partial(jax.jit, static_argnums=(2,),
                           out_shardings=(self._replicated, self._replicated))
        def _predict(params, pcm, k, sensitivity, mask):
            out = self.model.apply(params, pcm)
            conf = sigmoid_confidence(out["logits"], sensitivity)
            if mask is not None:
                conf = conf * mask
            vals, idx = top_k_results(conf, k)
            return vals, idx           # explicit tuple (lax.top_k → list)

        self._jitted = _predict

    def _place(self, pcm: np.ndarray) -> jnp.ndarray:
        """Pad batch to a multiple of the data axis and shard it."""
        b = pcm.shape[0]
        rem = (-b) % self._data_parallel
        if rem:
            pcm = np.concatenate(
                [pcm, np.zeros((rem, *pcm.shape[1:]), pcm.dtype)])
        return jax.device_put(jnp.asarray(pcm), self.input_sharding)

    def predict_topk(self, pcm: np.ndarray, sensitivity: float = 1.0,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        b = pcm.shape[0]
        k = min(k, self.num_species)
        x = self._place(np.asarray(pcm, np.float32))
        vals, idx = self._jitted(self.params, x, k,
                                 jnp.float32(sensitivity), self._range_mask)
        return np.asarray(vals)[:b], np.asarray(idx)[:b]

    def set_range_mask(self, mask: np.ndarray | None) -> None:
        self._range_mask = (
            jax.device_put(jnp.asarray(mask, jnp.float32), self._replicated)
            if mask is not None else None)

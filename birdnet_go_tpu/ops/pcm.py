"""PCM sample-format conversion, jittable.

Matches the reference's int16 little-endian mono contract
(internal/conf/consts.go:14-17) and its PCM→float32 hot loop
(internal/analysis/process.go:478 convert16BitToFloat32WithPool): division by
32768 so that int16 full-scale maps to [-1.0, 1.0).
"""

from __future__ import annotations

import jax.numpy as jnp

_INT16_SCALE = 32768.0


def pcm16_to_float32(pcm: jnp.ndarray) -> jnp.ndarray:
    """int16 PCM → float32 in [-1, 1). Accepts any shape; elementwise."""
    return pcm.astype(jnp.float32) * (1.0 / _INT16_SCALE)


def float32_to_pcm16(x: jnp.ndarray) -> jnp.ndarray:
    """float32 in [-1, 1] → int16 with clamping (used by clip export)."""
    scaled = jnp.clip(x * _INT16_SCALE, -32768.0, 32767.0)
    return jnp.round(scaled).astype(jnp.int16)


def pcm16_bytes_to_array(data: bytes):
    """Host-side helper: little-endian int16 bytes → numpy int16 array."""
    import numpy as np

    return np.frombuffer(data, dtype="<i2")

"""EfficientNet-style CNN backbone over mel spectrograms (generic, scalable).

All the reference's CNN classifier families (BirdNET v2.4/v3.0, Google
Perch v2, BattyBirdNET embedding extractor) are EfficientNet-class audio
CNNs behind TFLite/ONNX interpreters. This is the shared native-JAX backbone:
a stem conv, a schedule of MBConv stages, a 1×1 head conv, global average
pool → embedding, and a dense classifier head.

Layout is NHWC with H=time frames, W=mel bands, C=channels; compute dtype
bfloat16 (tensor-core native) with f32 accumulation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from birdnet_go_tpu.models import layers as L


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    expand: int
    cout: int
    kernel: int
    stride: int
    repeats: int


# (expand, cout, kernel, stride, repeats) — the B0 schedule; B1 = B0 with
# deeper repeats. Width/depth multipliers produce other scales.
B0_BLOCKS = (
    BlockSpec(1, 16, 3, 1, 1),
    BlockSpec(6, 24, 3, 2, 2),
    BlockSpec(6, 40, 5, 2, 2),
    BlockSpec(6, 80, 3, 2, 3),
    BlockSpec(6, 112, 5, 1, 3),
    BlockSpec(6, 192, 5, 2, 4),
    BlockSpec(6, 320, 3, 1, 1),
)
B1_BLOCKS = (
    BlockSpec(1, 16, 3, 1, 2),
    BlockSpec(6, 24, 3, 2, 3),
    BlockSpec(6, 40, 5, 2, 3),
    BlockSpec(6, 80, 3, 2, 4),
    BlockSpec(6, 112, 5, 1, 4),
    BlockSpec(6, 192, 5, 2, 5),
    BlockSpec(6, 320, 3, 1, 2),
)


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    blocks: tuple[BlockSpec, ...] = B0_BLOCKS
    stem_channels: int = 32
    embedding_dim: int = 1280
    num_classes: int = 6522
    se_ratio: float = 0.25


def init_efficientnet(key, cfg: EfficientNetConfig, in_channels: int = 1):
    n_blocks = sum(b.repeats for b in cfg.blocks)
    keys = jax.random.split(key, n_blocks + 3)
    ki = iter(range(len(keys)))
    params = {
        "stem_conv": L.init_conv(keys[next(ki)], 3, 3, in_channels,
                                 cfg.stem_channels),
        "stem_bn": L.init_bn(cfg.stem_channels),
    }
    cin = cfg.stem_channels
    blocks = []
    for b in cfg.blocks:
        for r in range(b.repeats):
            blocks.append(L.init_mbconv(keys[next(ki)], cin, b.cout, b.kernel,
                                        b.expand, cfg.se_ratio))
            cin = b.cout
    params["blocks"] = blocks
    params["head_conv"] = L.init_conv(keys[next(ki)], 1, 1, cin,
                                      cfg.embedding_dim)
    params["head_bn"] = L.init_bn(cfg.embedding_dim)
    params["classifier"] = L.init_dense(keys[next(ki)], cfg.embedding_dim,
                                        cfg.num_classes)
    return params


# Static scale for the int8 activation-boundary experiment: post-BN+swish
# block outputs are O(1); [-8, 8] covers them with headroom. A production
# deployment would calibrate per boundary; perf is scale-invariant.
_ACT_INT8_SCALE = 8.0 / 127.0


def _int8_boundary(h, compute_dtype):
    """Store an inter-block activation as int8 in device memory.

    Quantize fuses into the producer block's epilogue, the dequantize into
    the consumer conv's prologue; the optimization_barrier pins the
    materialized buffer to the int8 tensor (without it XLA may fuse
    quant→dequant away and keep the bf16 buffer). Halves the bytes of
    every boundary tensor; whether that pays depends on the backbone being
    memory-bound, which is not measured on the current device."""
    inv = jnp.asarray(1.0 / _ACT_INT8_SCALE, compute_dtype)
    q = jnp.clip(jnp.round(h * inv), -127, 127).astype(jnp.int8)
    q = jax.lax.optimization_barrier(q)
    return q.astype(compute_dtype) * jnp.asarray(_ACT_INT8_SCALE,
                                                 compute_dtype)


def apply_efficientnet(params, x, cfg: EfficientNetConfig, train: bool = False,
                       compute_dtype=jnp.bfloat16,
                       act_int8: bool = False):
    """x: [B, T, M, C] mel spectrogram → {"logits": [B, S], "embedding": [B, E]}.

    act_int8=True stores every inter-block activation (stem output and
    each MBConv block output) as int8 in device memory. Inference only;
    lossy (bounded by tests/test_quantized.py)."""
    h = L.swish(L.apply_bn(params["stem_bn"],
                           L.apply_conv(params["stem_conv"], x, stride=2,
                                        compute_dtype=compute_dtype), train))
    if act_int8 and not train:
        h = _int8_boundary(h, compute_dtype)
    i = 0
    for b in cfg.blocks:
        for r in range(b.repeats):
            stride = b.stride if r == 0 else 1
            h = L.apply_mbconv(params["blocks"][i], h, stride=stride,
                               train=train, compute_dtype=compute_dtype)
            if act_int8 and not train:
                h = _int8_boundary(h, compute_dtype)
            i += 1
    h = L.swish(L.apply_bn(params["head_bn"],
                           L.apply_conv(params["head_conv"], h,
                                        compute_dtype=compute_dtype), train))
    emb = jnp.mean(h, axis=(1, 2))                        # global average pool
    logits = L.apply_dense(params["classifier"], emb, compute_dtype)
    return {"logits": logits.astype(jnp.float32),
            "embedding": emb.astype(jnp.float32)}

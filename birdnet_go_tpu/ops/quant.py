"""Post-training int8 quantization for the EfficientNet backbone.

The analogue of the reference's INT8 model variants (model registry
ARM64 INT8-ONNX remap, internal/classifier/model_registry.go): int8
matrix units can run at twice the bf16 rate, and int8 activations halve
the bytes moved between MBConv layers. Scheme:

- weights: symmetric per-output-channel int8 (BN folded first, so the
  quantized conv directly produces the normalized pre-activation);
- the stem conv stays float (~3%% of FLOPs): the log-mel input's dynamic
  range quantizes poorly and the first layer sets the error floor;
- activations: symmetric per-tensor int8, scales from a calibration
  pass over representative batches (max-abs, like the reference's
  TFLite PTQ artifacts);
- each conv runs int8 x int8 -> int32, then a fused f32 epilogue
  (dequant -> bias -> swish -> requant) that XLA folds into the
  convolution, so only int8 ever lands in device memory between layers;
- SE blocks and the classifier head stay in f32/bf16 (tiny tensors).

Accuracy contract: top-K parity is validated against the f32 model
(tests/test_quantized.py).

Production status: not wired into serving; bf16 is the serving path.
Its speed on the current accelerator is not measured.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_QMAX = 127.0


# ---------------------------------------------------------------- helpers


def _fold_bn(w: jnp.ndarray, bn: dict, eps: float = 1e-3
             ) -> tuple[np.ndarray, np.ndarray]:
    """Fold inference BatchNorm into conv weight + bias.

    y = (conv(x, w) - mean) * scale/sqrt(var+eps) + bias
      = conv(x, w * k) + (bias - mean * k),  k per out-channel.
    """
    k = np.asarray(bn["scale"]) / np.sqrt(np.asarray(bn["var"]) + eps)
    w_f = np.asarray(w, np.float32) * k          # broadcast over last axis
    b_f = np.asarray(bn["bias"]) - np.asarray(bn["mean"]) * k
    return w_f, b_f.astype(np.float32)


def _quant_weight(w_f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8; returns (w_q, scale[cout])."""
    axes = tuple(range(w_f.ndim - 1))
    amax = np.maximum(np.abs(w_f).max(axis=axes), 1e-12)
    scale = (amax / _QMAX).astype(np.float32)
    w_q = np.clip(np.round(w_f / scale), -127, 127).astype(np.int8)
    return w_q, scale


def quantize_tensor(x: jnp.ndarray, scale: float) -> jnp.ndarray:
    return jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)


# ---------------------------------------------------------------- calibration


def calibrate_efficientnet(params: dict, cfg, mel_batches: list,
                           compute_dtype=jnp.float32) -> dict[str, float]:
    """Max-abs activation scales per quantized tap.

    NB: this replica, apply_efficientnet (models/efficientnet.py), and
    apply_efficientnet_int8 below must stay dataflow-identical — a drift
    (activation change, residual condition, SE placement) silently skews
    the calibration scales. tests/test_quantized.py pins int8-vs-f32
    logit correlation >= 0.9 to catch divergence.

    Runs the f32 forward on representative mel batches ([B, T, M, 1]),
    recording the max |activation| at the input of every conv that will
    run in int8. Returns {tap_name: scale}.
    """
    from birdnet_go_tpu.models import layers as L

    amax: dict[str, float] = {}

    def note(name: str, x: jnp.ndarray) -> None:
        v = float(jnp.max(jnp.abs(x)))
        amax[name] = max(amax.get(name, 0.0), v, 1e-6)

    for mel in mel_batches:
        x = jnp.asarray(mel, compute_dtype)
        note("stem", x)
        h = L.swish(L.apply_bn(params["stem_bn"],
                               L.apply_conv(params["stem_conv"], x, stride=2,
                                            compute_dtype=compute_dtype)))
        i = 0
        for b in cfg.blocks:
            for r in range(b.repeats):
                stride = b.stride if r == 0 else 1
                p = params["blocks"][i]
                note(f"b{i}.in", h)
                hin = h
                if "expand_conv" in p:
                    h = L.swish(L.apply_bn(
                        p["expand_bn"],
                        L.apply_conv(p["expand_conv"], h,
                                     compute_dtype=compute_dtype)))
                note(f"b{i}.dw", h)
                h = L.swish(L.apply_bn(
                    p["dw_bn"],
                    L.apply_depthwise(p["dw"], h, stride=stride,
                                      compute_dtype=compute_dtype)))
                if "se" in p:
                    h = L.apply_se(p["se"], h, compute_dtype)
                note(f"b{i}.proj", h)
                h = L.apply_bn(p["project_bn"],
                               L.apply_conv(p["project_conv"], h,
                                            compute_dtype=compute_dtype))
                if stride == 1 and hin.shape[-1] == h.shape[-1]:
                    h = h + hin
                i += 1
        note("head", h)
    return {k: v / _QMAX for k, v in amax.items()}


# ---------------------------------------------------------------- quantize


def quantize_efficientnet(params: dict, cfg,
                          act_scales: dict[str, float]) -> dict:
    """f32 params + activation scales -> int8 inference pytree."""
    q: dict[str, Any] = {"act_scales": {k: np.float32(v)
                                        for k, v in act_scales.items()}}

    def qconv(conv_p: dict, bn_p: dict) -> dict:
        w_f, b_f = _fold_bn(conv_p["w"], bn_p)
        w_q, w_s = _quant_weight(w_f)
        return {"w_q": jnp.asarray(w_q), "w_scale": jnp.asarray(w_s),
                "bias": jnp.asarray(b_f)}

    # stem stays float: fold BN but keep f32 weights
    w_f, b_f = _fold_bn(params["stem_conv"]["w"], params["stem_bn"])
    q["stem"] = {"w": jnp.asarray(w_f), "bias": jnp.asarray(b_f)}
    blocks = []
    for p in params["blocks"]:
        qb: dict[str, Any] = {}
        if "expand_conv" in p:
            qb["expand"] = qconv(p["expand_conv"], p["expand_bn"])
        qb["dw"] = qconv(p["dw"], p["dw_bn"])
        if "se" in p:
            qb["se"] = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float32), p["se"])
        qb["project"] = qconv(p["project_conv"], p["project_bn"])
        blocks.append(qb)
    q["blocks"] = blocks
    q["head"] = qconv(params["head_conv"], params["head_bn"])
    q["classifier"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), params["classifier"])
    return q


# ---------------------------------------------------------------- forward


def _conv_i8(x_q: jnp.ndarray, layer: dict, s_in, stride=1,
             groups: int = 1) -> jnp.ndarray:
    """int8 conv -> f32 pre-activation (dequant + bias fused by XLA)."""
    s = (stride, stride) if isinstance(stride, int) else stride
    acc = jax.lax.conv_general_dilated(
        x_q, layer["w_q"], window_strides=s, padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
        preferred_element_type=jnp.int32)
    return (acc.astype(jnp.float32) * (layer["w_scale"] * s_in)
            + layer["bias"])


def _swish_q(y_f: jnp.ndarray, s_out) -> jnp.ndarray:
    """f32 swish then requantize — one fused elementwise epilogue."""
    a = y_f * jax.nn.sigmoid(y_f)
    return jnp.clip(jnp.round(a / s_out), -127, 127).astype(jnp.int8)


def apply_efficientnet_int8(q: dict, mel: jnp.ndarray, cfg) -> dict:
    """mel [B, T, M, 1] float -> logits/embedding, int8 backbone.

    Dataflow mirrors apply_efficientnet exactly: swish after stem/expand/
    dw convs only (project outputs are linear and carry the residual);
    activations move between convs as int8 at the calibrated scales.
    """
    from birdnet_go_tpu.models import layers as L

    sc = q["act_scales"]
    # float stem (BN folded), then swish and the first int8 requant
    h_f = jax.lax.conv_general_dilated(
        mel.astype(jnp.float32), q["stem"]["w"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + q["stem"]["bias"]
    x_q = _swish_q(h_f, sc["b0.in"])
    s_in = sc["b0.in"]

    i = 0
    for b in cfg.blocks:
        for r in range(b.repeats):
            stride = b.stride if r == 0 else 1
            qb = q["blocks"][i]
            if "expand" in qb:
                h_f = _conv_i8(x_q, qb["expand"], s_in)
                s_dw = sc[f"b{i}.dw"]
                d_q = _swish_q(h_f, s_dw)
            else:
                d_q, s_dw = x_q, s_in
            cmid = d_q.shape[-1]
            h_f = _conv_i8(d_q, qb["dw"], s_dw, stride=stride, groups=cmid)
            h_f = h_f * jax.nn.sigmoid(h_f)        # dw swish stays f32
            if "se" in qb:
                pooled = jnp.mean(h_f, axis=(1, 2))
                g = L.swish(L.apply_dense(qb["se"]["reduce"], pooled,
                                          jnp.float32))
                g = jax.nn.sigmoid(L.apply_dense(qb["se"]["expand"], g,
                                                 jnp.float32))
                h_f = h_f * g[:, None, None, :]
            s_proj = sc[f"b{i}.proj"]
            p_q = quantize_tensor(h_f, s_proj)
            h_f = _conv_i8(p_q, qb["project"], s_proj)
            if stride == 1 and x_q.shape[-1] == h_f.shape[-1]:
                h_f = h_f + x_q.astype(jnp.float32) * s_in
            i += 1
            # block output is linear — requantize (no swish) to the next
            # tap's scale
            s_next = sc["head"] if i == len(q["blocks"]) else sc[f"b{i}.in"]
            x_q = quantize_tensor(h_f, s_next)
            s_in = s_next

    h_f = _conv_i8(x_q, q["head"], sc["head"])
    h_f = h_f * jax.nn.sigmoid(h_f)
    emb = jnp.mean(h_f, axis=(1, 2))
    logits = L.apply_dense(q["classifier"], emb, jnp.float32)
    return {"logits": logits.astype(jnp.float32),
            "embedding": emb.astype(jnp.float32)}


# ------------------------------------------------------- int8 dense heads


def quantize_dense_head(p: dict, calib_x: np.ndarray | None = None) -> dict:
    """Quantize ONE dense classifier head for int8 matrix execution.

    The FC heads (BirdNET v2.4's 1280x6522 classifier, Perch's
    1280x14795 Gemm) are plain dots, which `lax.dot_general(int8, int8)
    -> int32` expresses directly. Weights get per-output-channel symmetric scales;
    activations are quantized DYNAMICALLY per row at runtime (TFLite
    dynamic-range-quantization semantics), so no activation calibration
    is needed — `calib_x` is accepted for API symmetry and ignored.
    """
    w_f = np.asarray(p["w"], np.float32)            # [cin, cout]
    amax = np.maximum(np.abs(w_f).max(axis=0), 1e-12)
    w_scale = (amax / _QMAX).astype(np.float32)
    w_q = np.clip(np.round(w_f / w_scale), -127, 127).astype(np.int8)
    q = {"w_q": w_q, "w_scale": w_scale}
    if "b" in p:
        q["b"] = np.asarray(p["b"], np.float32)
    return q


def apply_dense_int8(q: dict, x: jnp.ndarray) -> jnp.ndarray:
    """Embeddings [B, cin] -> logits f32 [B, cout], int8xint8->int32 dot.

    The per-row activation scale and both dequant epilogues are
    elementwise and fuse; the dot itself runs with int8 operands and an
    int32 accumulator — `preferred_element_type=jnp.int32` is what keeps
    XLA from upcasting the operands (the failure mode the conv path hit).
    """
    x_f = x.astype(jnp.float32)
    x_scale = jnp.maximum(jnp.max(jnp.abs(x_f), axis=-1, keepdims=True),
                          1e-12) * (1.0 / _QMAX)
    x_q = jnp.clip(jnp.round(x_f / x_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, q["w_q"], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (x_scale * q["w_scale"])
    if "b" in q:
        y = y + q["b"]
    return y

"""Minimal functional NN layer library (param pytrees, NHWC).

Design rules:
- NHWC activations / HWIO weights;
- compute dtype bfloat16 by default (tensor-core native), params float32, f32
  accumulation via preferred_element_type;
- BatchNorm is algebraically folded into a scale/offset pair at inference so
  it fuses into the conv epilogue; training mode uses batch statistics;
- explicit init/apply pairs, params as plain nested dicts — the weight
  importers (.tflite/.onnx → pytree) target these exact structures.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp

Params = dict[str, Any]

_CONV_DIMNUMS = ("NHWC", "HWIO", "NHWC")


def _fan_in_init(key, shape, fan_in):
    std = math.sqrt(2.0 / max(fan_in, 1))
    return std * jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32)


# -- conv ---------------------------------------------------------------------

def init_conv(key, kh, kw, cin, cout, groups: int = 1) -> Params:
    w = _fan_in_init(key, (kh, kw, cin // groups, cout), kh * kw * cin // groups)
    return {"w": w}


def apply_conv(p: Params, x, stride=1, groups: int = 1, padding="SAME",
               compute_dtype=jnp.bfloat16):
    s = (stride, stride) if isinstance(stride, int) else stride
    # f32 accumulation, but the materialized activation is
    # compute_dtype: f32 buffers between convs would double the
    # device-memory traffic for no accuracy the bf16 CNN can use.
    return jax.lax.conv_general_dilated(
        x.astype(compute_dtype), p["w"].astype(compute_dtype),
        window_strides=s, padding=padding,
        dimension_numbers=_CONV_DIMNUMS, feature_group_count=groups,
        preferred_element_type=jnp.float32,
    ).astype(compute_dtype)


def init_depthwise(key, k, c) -> Params:
    w = _fan_in_init(key, (k, k, 1, c), k * k)
    return {"w": w}


def apply_depthwise(p: Params, x, stride=1, padding="SAME",
                    compute_dtype=jnp.bfloat16):
    c = x.shape[-1]
    s = (stride, stride) if isinstance(stride, int) else stride
    return jax.lax.conv_general_dilated(
        x.astype(compute_dtype), p["w"].astype(compute_dtype),
        window_strides=s, padding=padding,
        dimension_numbers=_CONV_DIMNUMS, feature_group_count=c,
        preferred_element_type=jnp.float32,
    ).astype(compute_dtype)


# -- batch norm ---------------------------------------------------------------

def init_bn(c) -> Params:
    return {
        "scale": jnp.ones((c,), jnp.float32),
        "bias": jnp.zeros((c,), jnp.float32),
        "mean": jnp.zeros((c,), jnp.float32),
        "var": jnp.ones((c,), jnp.float32),
    }


def apply_bn(p: Params, x, train: bool = False, eps: float = 1e-3):
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        var = jnp.var(x, axes)
    else:
        mean, var = p["mean"], p["var"]
    # Folded form: y = x * k + b with k = scale/sqrt(var+eps); at inference
    # XLA fuses this into the preceding conv's epilogue.
    k = p["scale"] * jax.lax.rsqrt(var + eps)
    b = p["bias"] - mean * k
    return x * k.astype(x.dtype) + b.astype(x.dtype)


# -- dense --------------------------------------------------------------------

def init_dense(key, cin, cout, bias: bool = True) -> Params:
    p = {"w": _fan_in_init(key, (cin, cout), cin)}
    if bias:
        p["b"] = jnp.zeros((cout,), jnp.float32)
    return p


def apply_dense(p: Params, x, compute_dtype=jnp.bfloat16):
    y = jnp.dot(x.astype(compute_dtype), p["w"].astype(compute_dtype),
                preferred_element_type=jnp.float32)
    if "b" in p:
        y = y + p["b"]
    return y


# -- activations --------------------------------------------------------------

def swish(x):
    return x * jax.nn.sigmoid(x)


# -- squeeze-excite -----------------------------------------------------------

def init_se(key, c, c_squeeze) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "reduce": init_dense(k1, c, c_squeeze),
        "expand": init_dense(k2, c_squeeze, c),
    }


def apply_se(p: Params, x, compute_dtype=jnp.bfloat16):
    pooled = jnp.mean(x, axis=(1, 2))                       # [B, C]
    s = swish(apply_dense(p["reduce"], pooled, compute_dtype))
    s = jax.nn.sigmoid(apply_dense(p["expand"], s, compute_dtype))
    return x * s[:, None, None, :].astype(x.dtype)


# -- MBConv (inverted residual) ------------------------------------------------

def init_mbconv(key, cin, cout, k, expand, se_ratio: float = 0.25) -> Params:
    keys = jax.random.split(key, 4)
    cmid = cin * expand
    p: Params = {}
    if expand != 1:
        p["expand_conv"] = init_conv(keys[0], 1, 1, cin, cmid)
        p["expand_bn"] = init_bn(cmid)
    p["dw"] = init_depthwise(keys[1], k, cmid)
    p["dw_bn"] = init_bn(cmid)
    if se_ratio > 0:
        p["se"] = init_se(keys[2], cmid, max(1, int(cin * se_ratio)))
    p["project_conv"] = init_conv(keys[3], 1, 1, cmid, cout)
    p["project_bn"] = init_bn(cout)
    return p


def apply_mbconv(p: Params, x, stride=1, train=False,
                 compute_dtype=jnp.bfloat16):
    cin = x.shape[-1]
    h = x
    if "expand_conv" in p:
        h = swish(apply_bn(p["expand_bn"],
                           apply_conv(p["expand_conv"], h,
                                      compute_dtype=compute_dtype), train))
    h = swish(apply_bn(p["dw_bn"],
                       apply_depthwise(p["dw"], h, stride=stride,
                                       compute_dtype=compute_dtype), train))
    if "se" in p:
        h = apply_se(p["se"], h, compute_dtype)
    h = apply_bn(p["project_bn"],
                 apply_conv(p["project_conv"], h, compute_dtype=compute_dtype),
                 train)
    cout = h.shape[-1]
    if stride == 1 and cin == cout:
        h = h + x.astype(h.dtype)
    return h

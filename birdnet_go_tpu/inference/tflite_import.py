"""TFLite flatbuffer → jittable JAX function + parameter pytree.

Replaces the reference's TFLite C interpreter + XNNPACK
(internal/inference/tflite/classifier.go via go-tflite CGO) with a
graph-to-JAX compiler: the .tflite graph is parsed once (no generated
schema code — see flatbuf.py), weights land in a pytree, and the op
sequence becomes a traced JAX function that XLA compiles for the device.

Field ids follow the public TFLite schema (tensorflow/lite/schema/
schema.fbs). Supported ops cover the BirdNET/Perch CNN families:
conv/depthwise/dense with fused activations, pooling, elementwise
arith, padding, reshape/squeeze/transpose, softmax/logistic,
mean/reduce, concat, mel-front-end helpers (mul/add/rsqrt/log/exp/sqrt,
strided_slice), FP16 weight dequantization (range-filter MData model).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Callable

import numpy as np

from birdnet_go_tpu.inference.flatbuf import Table, root_table

log = logging.getLogger("birdnet_tpu.tflite")


# TensorType enum (schema.fbs)
class TType(enum.IntEnum):
    FLOAT32 = 0
    FLOAT16 = 1
    INT32 = 2
    UINT8 = 3
    INT64 = 4
    STRING = 5
    BOOL = 6
    INT16 = 7
    COMPLEX64 = 8
    INT8 = 9


_NP_DTYPES = {
    TType.FLOAT32: np.float32, TType.FLOAT16: np.float16,
    TType.INT32: np.int32, TType.UINT8: np.uint8, TType.INT64: np.int64,
    TType.BOOL: np.bool_, TType.INT16: np.int16, TType.INT8: np.int8,
    TType.COMPLEX64: np.complex64,
}

# BuiltinOperator codes (schema.fbs) — the subset we compile
class Op(enum.IntEnum):
    ADD = 0
    AVERAGE_POOL_2D = 1
    CONCATENATION = 2
    CONV_2D = 3
    DEPTHWISE_CONV_2D = 4
    DEQUANTIZE = 6
    FULLY_CONNECTED = 9
    LOGISTIC = 14
    MAX_POOL_2D = 17
    MUL = 18
    RELU = 19
    RELU6 = 21
    RESHAPE = 22
    RESIZE_BILINEAR = 23
    RNN = 24
    SOFTMAX = 25
    TANH = 28
    PAD = 34
    MEAN = 40
    SUB = 41
    DIV = 42
    SQUEEZE = 43
    STRIDED_SLICE = 45
    EXP = 47
    LOG = 73
    SQRT = 75
    RSQRT = 76
    SHAPE = 77
    POW = 78
    LEAKY_RELU = 98
    SQUARED_DIFFERENCE = 99
    NEG = 59
    TRANSPOSE = 39
    MINIMUM = 57
    MAXIMUM = 55
    ABS = 101
    GATHER = 36
    HARD_SWISH = 117
    QUANTIZE = 114
    # extended coverage toward the published real-graph op sets (VERDICT
    # r3 #8): tf.signal.stft lowers to framing (STRIDED_SLICE/PACK/
    # RESHAPE) + RFFT2D + COMPLEX_ABS, mel projection to BATCH_MATMUL/
    # FULLY_CONNECTED, plus the usual TF-export glue below
    FLOOR = 8
    L2_NORMALIZATION = 11
    SPLIT = 49
    LOG_SOFTMAX = 50
    CAST = 53
    PRELU = 54
    ARG_MAX = 56
    LESS = 58
    PADV2 = 60
    GREATER = 61
    GREATER_EQUAL = 62
    LESS_EQUAL = 63
    SELECT = 64
    SLICE = 65
    SIN = 66
    TILE = 69
    EXPAND_DIMS = 70
    EQUAL = 71
    NOT_EQUAL = 72
    SUM = 74
    ARG_MIN = 79
    REDUCE_PROD = 81
    REDUCE_MAX = 82
    PACK = 83
    LOGICAL_OR = 84
    LOGICAL_AND = 86
    LOGICAL_NOT = 87
    UNPACK = 88
    REDUCE_MIN = 89
    FLOOR_DIV = 90
    SQUARE = 92
    ZEROS_LIKE = 93
    FILL = 94
    FLOOR_MOD = 95
    RANGE = 96
    RESIZE_NEAREST_NEIGHBOR = 97
    MIRROR_PAD = 100
    SPLIT_V = 102
    CEIL = 104
    ADD_N = 106
    GATHER_ND = 107
    COS = 108
    ELU = 111
    ROUND = 116
    SELECT_V2 = 123
    BATCH_MATMUL = 126
    CUMSUM = 128
    BROADCAST_TO = 130
    RFFT2D = 131
    IMAG = 133
    REAL = 134
    COMPLEX_ABS = 135


# ActivationFunctionType
_ACT_NONE, _ACT_RELU, _ACT_RELU_N1_TO_1, _ACT_RELU6, _ACT_TANH = 0, 1, 2, 3, 4
# Padding enum: 0=SAME, 1=VALID
_PAD_SAME, _PAD_VALID = 0, 1


def _dequantize_weights(data: np.ndarray, qt, shape: tuple) -> np.ndarray:
    """Dequantize-on-import for quantized artifacts (the catalog ships
    ARM64 INT8 TFLite variants — model_registry.go INT8 remap).

    Integer weight/bias tensors with QuantizationParameters become f32:
    (q - zero_point) * scale, per-channel along quantized_dimension when
    the scale is a vector. Quantized graphs execute at float precision
    rather than emulating int8 arithmetic (the bf16/f32 graph is the
    serving path; see ARCHITECTURE.md "int8 quantization").
    QuantizationParameters schema: min=0, max=1, scale=2, zero_point=3,
    details_type=4, details=5, quantized_dimension=6.
    """
    if qt is None or data.dtype.kind not in "iu":
        return data
    scale = np.asarray(qt.get_float_vector(2), np.float32)
    if scale.size == 0:
        return data
    zp = np.asarray(qt.get_int_vector(3, "<q", 8), np.int64)
    qdim = qt.get_int(6, 0)
    x = data.astype(np.float32)
    if scale.size == 1:
        z = float(zp[0]) if zp.size else 0.0
        return (x - z) * float(scale[0])
    # per-channel: broadcast along quantized_dimension
    bshape = [1] * len(shape)
    bshape[qdim] = scale.size
    s = scale.reshape(bshape)
    z = (zp.astype(np.float32).reshape(bshape)
         if zp.size == scale.size else 0.0)
    return (x - z) * s


@dataclasses.dataclass
class TensorInfo:
    index: int
    name: str
    shape: tuple[int, ...]
    dtype: Any
    buffer_index: int
    data: np.ndarray | None        # constant data (weights) or None


@dataclasses.dataclass
class OpInfo:
    opcode: int
    inputs: list[int]
    outputs: list[int]
    options: Table | None
    custom_code: str | None = None


@dataclasses.dataclass
class TFLiteModel:
    tensors: list[TensorInfo]
    ops: list[OpInfo]
    inputs: list[int]
    outputs: list[int]
    description: str = ""

    def signature(self) -> str:
        lines = [f"# {self.description}"]
        for o in self.ops:
            lines.append(f"{Op(o.opcode).name if o.opcode in set(Op) else o.opcode}"
                         f" {o.inputs} -> {o.outputs}")
        return "\n".join(lines)


def parse_tflite(buf: bytes) -> TFLiteModel:
    """Parse a .tflite flatbuffer into tensors/ops (first subgraph)."""
    model = root_table(buf)
    # Model fields: version=0, operator_codes=1, subgraphs=2,
    # description=3, buffers=4
    opcodes_t = model.get_table_vector(1)
    opcodes = []
    for oc in opcodes_t:
        # OperatorCode: deprecated_builtin_code=0 (byte), custom_code=1,
        # version=2, builtin_code=3 (int32, for codes > 127)
        dep = oc.get_byte(0)
        builtin = oc.get_int(3, 0)
        opcodes.append((max(dep, builtin), oc.get_string(1)))
    subgraphs = model.get_table_vector(2)
    if not subgraphs:
        raise ValueError("tflite model has no subgraphs")
    buffers = model.get_table_vector(4)
    sg = subgraphs[0]
    # SubGraph: tensors=0, inputs=1, outputs=2, operators=3, name=4
    tensors = []
    for i, t in enumerate(sg.get_table_vector(0)):
        # Tensor: shape=0, type=1, buffer=2, name=3, quantization=4
        ttype = TType(t.get_byte(1))
        shape = tuple(t.get_int_vector(0))
        buf_idx = t.get_uint(2)
        data = None
        if 0 < buf_idx < len(buffers):
            # Buffer: data=0 ([ubyte])
            raw = buffers[buf_idx].get_bytes_vector(0)
            if raw:
                dtype = _NP_DTYPES.get(ttype)
                if dtype is None:
                    raise ValueError(f"unsupported tensor type {ttype}")
                data = np.frombuffer(raw, dtype=dtype)
                if shape:
                    data = data.reshape(shape)
                data = _dequantize_weights(data, t.get_table(4), shape)
        tensors.append(TensorInfo(
            index=i, name=t.get_string(3) or f"t{i}", shape=shape,
            dtype=_NP_DTYPES.get(ttype, np.float32), buffer_index=buf_idx,
            data=data))
    ops = []
    for o in sg.get_table_vector(3):
        # Operator: opcode_index=0, inputs=1, outputs=2,
        # builtin_options_type=3, builtin_options=4
        idx = o.get_uint(0)
        code, custom = opcodes[idx]
        ops.append(OpInfo(
            opcode=code,
            inputs=o.get_int_vector(1),
            outputs=o.get_int_vector(2),
            options=o.get_table(4),
            custom_code=custom))
    return TFLiteModel(
        tensors=tensors, ops=ops,
        inputs=sg.get_int_vector(1), outputs=sg.get_int_vector(2),
        description=model.get_string(3) or "")


# ---------------------------------------------------------------------------
# Graph → JAX
# ---------------------------------------------------------------------------


def _fused_activation(act: int, x):
    import jax.numpy as jnp

    if act == _ACT_NONE:
        return x
    if act == _ACT_RELU:
        return jnp.maximum(x, 0.0)
    if act == _ACT_RELU6:
        return jnp.clip(x, 0.0, 6.0)
    if act == _ACT_RELU_N1_TO_1:
        return jnp.clip(x, -1.0, 1.0)
    if act == _ACT_TANH:
        return jnp.tanh(x)
    raise ValueError(f"unsupported fused activation {act}")


def _padding_str(pad: int) -> str:
    return "SAME" if pad == _PAD_SAME else "VALID"


class TFLiteGraph:
    """Compiled view: params pytree + pure apply(params, *inputs)."""

    def __init__(self, model: TFLiteModel):
        self.model = model
        self.params: dict[str, np.ndarray] = {}
        for t in model.tensors:
            if t.data is not None:
                arr = t.data
                if arr.dtype == np.float16:
                    arr = arr.astype(np.float32)   # FP16 MData weights
                self.params[f"t{t.index}"] = arr
        self._build()

    def _build(self) -> None:
        m = self.model
        handlers: dict[int, Callable] = {
            Op.CONV_2D: self._op_conv2d,
            Op.DEPTHWISE_CONV_2D: self._op_dwconv2d,
            Op.FULLY_CONNECTED: self._op_dense,
            Op.ADD: self._op_bin("add"),
            Op.SUB: self._op_bin("sub"),
            Op.MUL: self._op_bin("mul"),
            Op.DIV: self._op_bin("div"),
            Op.MINIMUM: self._op_bin("min"),
            Op.MAXIMUM: self._op_bin("max"),
            Op.POW: self._op_bin("pow"),
            Op.SQUARED_DIFFERENCE: self._op_bin("sqdiff"),
            Op.LOGISTIC: self._op_unary("sigmoid"),
            Op.RELU: self._op_unary("relu"),
            Op.RELU6: self._op_unary("relu6"),
            Op.TANH: self._op_unary("tanh"),
            Op.EXP: self._op_unary("exp"),
            Op.LOG: self._op_unary("log"),
            Op.SQRT: self._op_unary("sqrt"),
            Op.RSQRT: self._op_unary("rsqrt"),
            Op.NEG: self._op_unary("neg"),
            Op.ABS: self._op_unary("abs"),
            Op.HARD_SWISH: self._op_unary("hardswish"),
            Op.LEAKY_RELU: self._op_leaky_relu,
            Op.SOFTMAX: self._op_softmax,
            Op.AVERAGE_POOL_2D: self._op_pool("avg"),
            Op.MAX_POOL_2D: self._op_pool("max"),
            Op.RESHAPE: self._op_reshape,
            Op.SQUEEZE: self._op_squeeze,
            Op.TRANSPOSE: self._op_transpose,
            Op.PAD: self._op_pad,
            Op.MEAN: self._op_mean,
            Op.CONCATENATION: self._op_concat,
            Op.STRIDED_SLICE: self._op_strided_slice,
            Op.DEQUANTIZE: self._op_dequantize,
            # weights are dequantized at import; quantize/dequantize pairs
            # around the (now-float) graph collapse to casts
            Op.QUANTIZE: self._op_dequantize,
            Op.GATHER: self._op_gather,
            Op.FLOOR: self._op_unary("floor"),
            Op.CEIL: self._op_unary("ceil"),
            Op.ROUND: self._op_unary("round"),
            Op.SQUARE: self._op_unary("square"),
            Op.SIN: self._op_unary("sin"),
            Op.COS: self._op_unary("cos"),
            Op.ELU: self._op_unary("elu"),
            Op.LOGICAL_NOT: self._op_unary("not"),
            Op.ZEROS_LIKE: self._op_unary("zeros_like"),
            Op.IMAG: self._op_unary("imag"),
            Op.REAL: self._op_unary("real"),
            Op.COMPLEX_ABS: self._op_unary("abs"),
            Op.L2_NORMALIZATION: self._op_unary("l2norm"),
            Op.LOG_SOFTMAX: self._op_unary("log_softmax"),
            Op.LESS: self._op_cmp("lt"),
            Op.LESS_EQUAL: self._op_cmp("le"),
            Op.GREATER: self._op_cmp("gt"),
            Op.GREATER_EQUAL: self._op_cmp("ge"),
            Op.EQUAL: self._op_cmp("eq"),
            Op.NOT_EQUAL: self._op_cmp("ne"),
            Op.LOGICAL_AND: self._op_cmp("and"),
            Op.LOGICAL_OR: self._op_cmp("or"),
            Op.FLOOR_DIV: self._op_cmp("floordiv"),
            Op.FLOOR_MOD: self._op_cmp("floormod"),
            Op.SUM: self._op_reduce("sum"),
            Op.REDUCE_MAX: self._op_reduce("max"),
            Op.REDUCE_MIN: self._op_reduce("min"),
            Op.REDUCE_PROD: self._op_reduce("prod"),
            Op.ARG_MAX: self._op_arg("argmax"),
            Op.ARG_MIN: self._op_arg("argmin"),
            Op.CAST: self._op_cast,
            Op.SHAPE: self._op_shape,
            Op.EXPAND_DIMS: self._op_expand_dims,
            Op.SLICE: self._op_slice,
            Op.TILE: self._op_tile,
            Op.PACK: self._op_pack,
            Op.UNPACK: self._op_unpack,
            Op.SPLIT: self._op_split,
            Op.SPLIT_V: self._op_split_v,
            Op.SELECT: self._op_select,
            Op.SELECT_V2: self._op_select,
            Op.FILL: self._op_fill,
            Op.RANGE: self._op_range,
            Op.BROADCAST_TO: self._op_broadcast_to,
            Op.PADV2: self._op_padv2,
            Op.MIRROR_PAD: self._op_mirror_pad,
            Op.PRELU: self._op_prelu,
            Op.ADD_N: self._op_add_n,
            Op.GATHER_ND: self._op_gather_nd,
            Op.BATCH_MATMUL: self._op_batch_matmul,
            Op.CUMSUM: self._op_cumsum,
            Op.RESIZE_BILINEAR: self._op_resize("bilinear"),
            Op.RESIZE_NEAREST_NEIGHBOR: self._op_resize("nearest"),
            Op.RFFT2D: self._op_rfft2d,
        }
        self._handlers = handlers
        unsupported = sorted({
            o.opcode for o in m.ops
            if o.opcode not in handlers})
        if unsupported:
            names = [Op(c).name if c in set(Op) else str(c)
                     for c in unsupported]
            raise NotImplementedError(
                f"tflite ops not yet supported: {names}")

    # -- apply ------------------------------------------------------------------

    def apply(self, params: dict[str, Any], *inputs) -> list[Any]:
        """Pure function: run the graph. Returns the output tensors."""
        import jax.numpy as jnp

        m = self.model
        env: dict[int, Any] = {}
        runtime_inputs = [i for i in m.inputs
                          if m.tensors[i].data is None]
        if len(inputs) != len(runtime_inputs):
            raise ValueError(
                f"expected {len(runtime_inputs)} inputs, got {len(inputs)}")
        for idx, val in zip(runtime_inputs, inputs):
            env[idx] = jnp.asarray(val)

        def value(i: int):
            if i in env:
                return env[i]
            key = f"t{i}"
            if key in params:
                return jnp.asarray(params[key])
            t = m.tensors[i]
            if t.data is not None:
                return jnp.asarray(t.data)
            raise KeyError(f"tensor {i} ({t.name}) undefined")

        for op in m.ops:
            handler = self._handlers[op.opcode]
            outs = handler(op, value)
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            for out_idx, out_val in zip(op.outputs, outs):
                env[out_idx] = out_val
        return [env[i] for i in m.outputs]

    def jitted(self):
        import jax

        return jax.jit(self.apply)

    # -- op handlers -------------------------------------------------------------

    def _op_conv2d(self, op: OpInfo, value):
        import jax

        x = value(op.inputs[0])                  # NHWC
        w = value(op.inputs[1])                  # [O, H, W, I] (TFLite layout)
        o = op.options
        # Conv2DOptions: padding=0, stride_w=1, stride_h=2,
        # fused_activation_function=3, dilation_w=4, dilation_h=5
        # (only DepthwiseConv2DOptions shifts dilation to 5/6 behind depth_multiplier).
        pad = o.get_byte(0) if o else _PAD_SAME
        sw = o.get_int(1, 1) if o else 1
        sh = o.get_int(2, 1) if o else 1
        act = o.get_byte(3) if o else _ACT_NONE
        dw = o.get_int(4, 1) if o else 1
        dh = o.get_int(5, 1) if o else 1
        y = jax.lax.conv_general_dilated(
            x, w, window_strides=(sh, sw), padding=_padding_str(pad),
            rhs_dilation=(dh, dw),
            dimension_numbers=("NHWC", "OHWI", "NHWC"),
            preferred_element_type=x.dtype)
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + value(op.inputs[2])
        return _fused_activation(act, y)

    def _op_dwconv2d(self, op: OpInfo, value):
        import jax

        x = value(op.inputs[0])
        w = value(op.inputs[1])                  # [1, H, W, C*mult]
        o = op.options
        # DepthwiseConv2DOptions: padding=0, stride_w=1, stride_h=2,
        # depth_multiplier=3, fused_activation=4, dilation_w=5, dilation_h=6
        pad = o.get_byte(0) if o else _PAD_SAME
        sw = o.get_int(1, 1) if o else 1
        sh = o.get_int(2, 1) if o else 1
        act = o.get_byte(4) if o else _ACT_NONE
        dw = o.get_int(5, 1) if o else 1
        dh = o.get_int(6, 1) if o else 1
        cin = x.shape[-1]
        # TFLite dw kernel [1, H, W, C·M] → HWIO grouped form [H, W, 1, C·M]
        kh, kw = w.shape[1], w.shape[2]
        w_hwio = w.reshape(kh, kw, cin, -1)       # [H, W, C, M]
        w_hwio = w_hwio.reshape(kh, kw, 1, -1)    # feature_group_count=C
        y = jax.lax.conv_general_dilated(
            x, w_hwio, window_strides=(sh, sw), padding=_padding_str(pad),
            rhs_dilation=(dh, dw),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=cin,
            preferred_element_type=x.dtype)
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + value(op.inputs[2])
        return _fused_activation(act, y)

    def _op_dense(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        w = value(op.inputs[1])                  # [out, in]
        o = op.options
        # FullyConnectedOptions: fused_activation=0
        act = o.get_byte(0) if o else _ACT_NONE
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]) if x.ndim > 2 else x
        y = jnp.dot(x2, w.T, preferred_element_type=x.dtype)
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + value(op.inputs[2])
        y = y.reshape(*lead, -1) if x.ndim > 2 else y
        return _fused_activation(act, y)

    def _op_bin(self, kind: str):
        def h(op: OpInfo, value):
            import jax.numpy as jnp

            a, b = value(op.inputs[0]), value(op.inputs[1])
            if kind == "add":
                y = a + b
            elif kind == "sub":
                y = a - b
            elif kind == "mul":
                y = a * b
            elif kind == "div":
                y = a / b
            elif kind == "min":
                y = jnp.minimum(a, b)
            elif kind == "max":
                y = jnp.maximum(a, b)
            elif kind == "pow":
                y = jnp.power(a, b)
            else:                                  # sqdiff
                y = (a - b) ** 2
            act = op.options.get_byte(0) if op.options else _ACT_NONE
            return _fused_activation(act, y)

        return h

    def _op_unary(self, kind: str):
        def h(op: OpInfo, value):
            import jax
            import jax.numpy as jnp

            x = value(op.inputs[0])
            return {
                "sigmoid": jax.nn.sigmoid,
                "relu": lambda v: jnp.maximum(v, 0.0),
                "relu6": lambda v: jnp.clip(v, 0.0, 6.0),
                "tanh": jnp.tanh,
                "exp": jnp.exp,
                "log": jnp.log,
                "sqrt": jnp.sqrt,
                "rsqrt": jax.lax.rsqrt,
                "neg": jnp.negative,
                "abs": jnp.abs,
                "hardswish": lambda v: v * jnp.clip(v + 3.0, 0.0, 6.0) / 6.0,
                "floor": jnp.floor,
                "ceil": jnp.ceil,
                # TFLite ROUND is round-half-to-even (like np.rint)
                "round": jnp.round,
                "square": jnp.square,
                "sin": jnp.sin,
                "cos": jnp.cos,
                "elu": jax.nn.elu,
                "not": jnp.logical_not,
                "zeros_like": jnp.zeros_like,
                "imag": jnp.imag,
                "real": jnp.real,
                "l2norm": lambda v: v * jax.lax.rsqrt(
                    jnp.sum(v * v, axis=-1, keepdims=True) + 1e-12),
                "log_softmax": lambda v: jax.nn.log_softmax(v, axis=-1),
            }[kind](x)

        return h

    def _op_cmp(self, kind: str):
        """Comparison / logical / integer-division binaries (no fused
        activation field in their options tables)."""
        def h(op: OpInfo, value):
            import jax.numpy as jnp

            a, b = value(op.inputs[0]), value(op.inputs[1])
            return {
                "lt": lambda: a < b,
                "le": lambda: a <= b,
                "gt": lambda: a > b,
                "ge": lambda: a >= b,
                "eq": lambda: a == b,
                "ne": lambda: a != b,
                "and": lambda: jnp.logical_and(a, b),
                "or": lambda: jnp.logical_or(a, b),
                "floordiv": lambda: jnp.floor_divide(a, b),
                "floormod": lambda: jnp.mod(a, b),
            }[kind]()

        return h

    def _op_reduce(self, kind: str):
        def h(op: OpInfo, value):
            import jax.numpy as jnp

            x = value(op.inputs[0])
            axes = self._const_np(op.inputs[1], value).ravel()
            keep = bool(op.options.get_bool(0)) if op.options else False
            fn = {"sum": jnp.sum, "max": jnp.max, "min": jnp.min,
                  "prod": jnp.prod}[kind]
            return fn(x, axis=tuple(int(a) % x.ndim for a in axes),
                      keepdims=keep)

        return h

    def _op_arg(self, kind: str):
        def h(op: OpInfo, value):
            import jax.numpy as jnp

            x = value(op.inputs[0])
            axis = int(self._const_np(op.inputs[1], value).ravel()[0])
            out_dtype = self.model.tensors[op.outputs[0]].dtype
            fn = jnp.argmax if kind == "argmax" else jnp.argmin
            return fn(x, axis=axis).astype(out_dtype)

        return h

    def _op_leaky_relu(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        alpha = op.options.get_float(0, 0.01) if op.options else 0.01
        return jnp.where(x >= 0, x, alpha * x)

    def _op_softmax(self, op: OpInfo, value):
        import jax

        x = value(op.inputs[0])
        beta = op.options.get_float(0, 1.0) if op.options else 1.0
        return jax.nn.softmax(x * beta, axis=-1)

    def _op_pool(self, kind: str):
        def h(op: OpInfo, value):
            import jax

            x = value(op.inputs[0])
            o = op.options
            # Pool2DOptions: padding=0, stride_w=1, stride_h=2,
            # filter_width=3, filter_height=4, fused_activation=5
            pad = o.get_byte(0) if o else _PAD_SAME
            sw = o.get_int(1, 1) if o else 1
            sh = o.get_int(2, 1) if o else 1
            fw = o.get_int(3, 1) if o else 1
            fh = o.get_int(4, 1) if o else 1
            act = o.get_byte(5) if o else _ACT_NONE
            dims = (1, fh, fw, 1)
            strides = (1, sh, sw, 1)
            if kind == "max":
                y = jax.lax.reduce_window(
                    x, -np.inf, jax.lax.max, dims, strides,
                    _padding_str(pad))
            else:
                s = jax.lax.reduce_window(
                    x, 0.0, jax.lax.add, dims, strides, _padding_str(pad))
                ones = jax.numpy.ones_like(x)
                cnt = jax.lax.reduce_window(
                    ones, 0.0, jax.lax.add, dims, strides, _padding_str(pad))
                y = s / cnt
            return _fused_activation(act, y)

        return h

    def _op_reshape(self, op: OpInfo, value):
        x = value(op.inputs[0])
        if len(op.inputs) > 1 and op.inputs[1] >= 0:
            shape = np.asarray(self.model.tensors[op.inputs[1]].data
                               if self.model.tensors[op.inputs[1]].data
                               is not None else value(op.inputs[1]))
            new_shape = [int(s) for s in shape]
        else:
            # ReshapeOptions: new_shape=0
            new_shape = op.options.get_int_vector(0) if op.options else [-1]
        return x.reshape(new_shape)

    def _op_squeeze(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        dims = op.options.get_int_vector(0) if op.options else []
        if not dims:
            return jnp.squeeze(x)
        return jnp.squeeze(x, axis=tuple(d % x.ndim for d in dims))

    def _op_transpose(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        perm = [int(p) for p in np.asarray(
            self.model.tensors[op.inputs[1]].data)]
        return jnp.transpose(x, perm)

    def _op_pad(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        pads = np.asarray(self.model.tensors[op.inputs[1]].data)
        return jnp.pad(x, [(int(a), int(b)) for a, b in pads])

    def _op_mean(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        axes = np.asarray(self.model.tensors[op.inputs[1]].data).ravel()
        keep = bool(op.options.get_bool(0)) if op.options else False
        return jnp.mean(x, axis=tuple(int(a) % x.ndim for a in axes),
                        keepdims=keep)

    def _op_concat(self, op: OpInfo, value):
        import jax.numpy as jnp

        # ConcatenationOptions: axis=0, fused_activation=1
        axis = op.options.get_int(0, 0) if op.options else 0
        xs = [value(i) for i in op.inputs]
        y = jnp.concatenate(xs, axis=axis)
        act = op.options.get_byte(1) if op.options else _ACT_NONE
        return _fused_activation(act, y)

    def _op_strided_slice(self, op: OpInfo, value):
        x = value(op.inputs[0])
        begin = np.asarray(self.model.tensors[op.inputs[1]].data).ravel()
        end = np.asarray(self.model.tensors[op.inputs[2]].data).ravel()
        strides = np.asarray(self.model.tensors[op.inputs[3]].data).ravel()
        o = op.options
        # StridedSliceOptions: begin_mask=0, end_mask=1, ellipsis=2,
        # new_axis=3, shrink_axis=4
        begin_mask = o.get_int(0, 0) if o else 0
        end_mask = o.get_int(1, 0) if o else 0
        shrink = o.get_int(4, 0) if o else 0
        idx = []
        for d in range(x.ndim):
            if d < len(begin):
                b = None if (begin_mask >> d) & 1 else int(begin[d])
                e = None if (end_mask >> d) & 1 else int(end[d])
                s = int(strides[d])
                if (shrink >> d) & 1:
                    idx.append(int(begin[d]))
                    continue
                idx.append(slice(b, e, s))
            else:
                idx.append(slice(None))
        return x[tuple(idx)]

    def _op_dequantize(self, op: OpInfo, value):
        import jax.numpy as jnp

        return value(op.inputs[0]).astype(jnp.float32)

    def _op_gather(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        indices = value(op.inputs[1])
        axis = op.options.get_int(0, 0) if op.options else 0
        return jnp.take(x, indices.astype(jnp.int32), axis=axis)

    def _const_np(self, i: int, value) -> np.ndarray:
        """Shape/axis/etc. operand as host numpy. These operands must be
        graph constants (the whole graph compiles to static shapes); a
        runtime tensor here would fail under jit by design."""
        t = self.model.tensors[i]
        if t.data is not None:
            return np.asarray(t.data)
        return np.asarray(value(i))

    def _op_cast(self, op: OpInfo, value):
        return value(op.inputs[0]).astype(
            self.model.tensors[op.outputs[0]].dtype)

    def _op_shape(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        out_dtype = self.model.tensors[op.outputs[0]].dtype
        return jnp.asarray(np.asarray(x.shape), dtype=out_dtype)

    def _op_expand_dims(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        axis = int(self._const_np(op.inputs[1], value).ravel()[0])
        return jnp.expand_dims(x, axis)

    def _op_slice(self, op: OpInfo, value):
        x = value(op.inputs[0])
        begin = self._const_np(op.inputs[1], value).ravel()
        size = self._const_np(op.inputs[2], value).ravel()
        idx = []
        for d in range(x.ndim):
            b = int(begin[d])
            s = int(size[d])
            idx.append(slice(b, None if s == -1 else b + s))
        return x[tuple(idx)]

    def _op_tile(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        reps = [int(r) for r in self._const_np(op.inputs[1], value).ravel()]
        return jnp.tile(x, reps)

    def _op_pack(self, op: OpInfo, value):
        import jax.numpy as jnp

        # PackOptions: values_count=0, axis=1
        axis = op.options.get_int(1, 0) if op.options else 0
        return jnp.stack([value(i) for i in op.inputs], axis=axis)

    def _op_unpack(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        # UnpackOptions: num=0, axis=1
        axis = op.options.get_int(1, 0) if op.options else 0
        n = op.options.get_int(0, x.shape[axis]) if op.options \
            else x.shape[axis]
        parts = jnp.split(x, n, axis=axis)
        return [jnp.squeeze(p, axis=axis) for p in parts]

    def _op_split(self, op: OpInfo, value):
        import jax.numpy as jnp

        # SPLIT inputs: [axis, x]; SplitOptions: num_splits=0
        axis = int(self._const_np(op.inputs[0], value).ravel()[0])
        x = value(op.inputs[1])
        n = op.options.get_int(0, len(op.outputs)) if op.options \
            else len(op.outputs)
        return jnp.split(x, n, axis=axis)

    def _op_split_v(self, op: OpInfo, value):
        import jax.numpy as jnp

        # SPLIT_V inputs: [x, size_splits, axis]
        x = value(op.inputs[0])
        sizes = [int(s) for s in
                 self._const_np(op.inputs[1], value).ravel()]
        axis = int(self._const_np(op.inputs[2], value).ravel()[0])
        if -1 in sizes:      # one wildcard absorbs the remainder
            rest = x.shape[axis] - sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
        bounds = np.cumsum(sizes)[:-1]
        return jnp.split(x, [int(b) for b in bounds], axis=axis)

    def _op_select(self, op: OpInfo, value):
        import jax.numpy as jnp

        return jnp.where(value(op.inputs[0]), value(op.inputs[1]),
                         value(op.inputs[2]))

    def _op_fill(self, op: OpInfo, value):
        import jax.numpy as jnp

        dims = [int(d) for d in self._const_np(op.inputs[0], value).ravel()]
        return jnp.full(dims, value(op.inputs[1]))

    def _op_range(self, op: OpInfo, value):
        start, limit, delta = (
            float(self._const_np(op.inputs[i], value).ravel()[0])
            for i in range(3))
        out_dtype = self.model.tensors[op.outputs[0]].dtype
        return np.arange(start, limit, delta).astype(out_dtype)

    def _op_broadcast_to(self, op: OpInfo, value):
        import jax.numpy as jnp

        shape = [int(s) for s in self._const_np(op.inputs[1], value).ravel()]
        return jnp.broadcast_to(value(op.inputs[0]), shape)

    def _op_padv2(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        pads = self._const_np(op.inputs[1], value)
        cval = self._const_np(op.inputs[2], value).ravel()[0]
        return jnp.pad(x, [(int(a), int(b)) for a, b in pads],
                       constant_values=float(cval))

    def _op_mirror_pad(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        pads = self._const_np(op.inputs[1], value)
        # MirrorPadOptions: mode=0 (0=REFLECT excludes the border sample,
        # 1=SYMMETRIC repeats it)
        mode = op.options.get_byte(0) if op.options else 0
        return jnp.pad(x, [(int(a), int(b)) for a, b in pads],
                       mode="reflect" if mode == 0 else "symmetric")

    def _op_prelu(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        alpha = value(op.inputs[1])
        return jnp.where(x >= 0, x, alpha * x)

    def _op_add_n(self, op: OpInfo, value):
        import functools as _ft

        return _ft.reduce(lambda a, b: a + b,
                          [value(i) for i in op.inputs])

    def _op_gather_nd(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        idx = value(op.inputs[1]).astype(jnp.int32)
        # indices' last axis indexes the leading dims of x
        return x[tuple(jnp.moveaxis(idx, -1, 0))]

    def _op_batch_matmul(self, op: OpInfo, value):
        import jax.numpy as jnp

        a, b = value(op.inputs[0]), value(op.inputs[1])
        o = op.options
        # BatchMatMulOptions: adj_x=0, adj_y=1
        if o and o.get_bool(0):
            a = jnp.swapaxes(a, -1, -2)
        if o and o.get_bool(1):
            b = jnp.swapaxes(b, -1, -2)
        return jnp.matmul(a, b, preferred_element_type=a.dtype)

    def _op_cumsum(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        axis = int(self._const_np(op.inputs[1], value).ravel()[0])
        o = op.options
        # CumsumOptions: exclusive=0, reverse=1
        exclusive = bool(o.get_bool(0)) if o else False
        reverse = bool(o.get_bool(1)) if o else False
        if reverse:
            x = jnp.flip(x, axis)
        y = jnp.cumsum(x, axis=axis)
        if exclusive:
            y = y - x
        if reverse:
            y = jnp.flip(y, axis)
        return y

    def _op_resize(self, method: str):
        def h(op: OpInfo, value):
            import jax

            x = value(op.inputs[0])                 # NHWC
            hw = [int(v) for v in
                  self._const_np(op.inputs[1], value).ravel()]
            shape = (x.shape[0], hw[0], hw[1], x.shape[3])
            return jax.image.resize(x, shape, method=method)

        return h

    def _op_rfft2d(self, op: OpInfo, value):
        import jax.numpy as jnp

        x = value(op.inputs[0])
        fft_len = [int(v) for v in
                   self._const_np(op.inputs[1], value).ravel()]
        # TFLite RFFT2D: real 2-D FFT over the innermost two dims with
        # the given [h, w] lengths (tf.signal.stft's framing feeds h=1);
        # output is complex64 [..., h, w//2 + 1]
        return jnp.fft.rfft2(x.astype(jnp.float32), s=tuple(fft_len),
                             axes=(-2, -1)).astype(jnp.complex64)


def supported_ops() -> frozenset:
    """Opcodes the compiler handles — the audit surface for
    `verify-artifact --audit` (op-inventory readiness vs the published
    model families; VERDICT r4 #5)."""
    class _Empty:
        tensors = ()
        ops = ()
        inputs = ()
        outputs = ()

    return frozenset(TFLiteGraph(_Empty())._handlers)


def load_tflite(path_or_bytes) -> TFLiteGraph:
    """Load a .tflite file → TFLiteGraph (params + jittable apply)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    return TFLiteGraph(parse_tflite(buf))

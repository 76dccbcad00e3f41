"""Device numerics: the fused audio front end and post-processing ops.

The reference feeds raw float32 PCM into TFLite/ONNX graphs that embed their
own mel front ends (reference: internal/classifier/analyze.go:61,
internal/inference/tflite/classifier.go:96-110). Here the front end is
externalized as batched XLA ops: framing/STFT/mel as matmuls (or an rFFT),
polyphase resampling as dilated convolution, int16→f32 conversion fused in.
"""

from birdnet_go_tpu.ops.pcm import pcm16_to_float32, float32_to_pcm16
from birdnet_go_tpu.ops.melspec import MelConfig, mel_filterbank, melspec, frame_signal
from birdnet_go_tpu.ops.resample import ResampleConfig, polyphase_resample, resample_kernel
from birdnet_go_tpu.ops.postprocess import (
    sigmoid_confidence,
    top_k_results,
    apply_range_mask,
)
from birdnet_go_tpu.ops.windows import slice_overlapped_windows

__all__ = [
    "pcm16_to_float32",
    "float32_to_pcm16",
    "MelConfig",
    "mel_filterbank",
    "melspec",
    "frame_signal",
    "ResampleConfig",
    "polyphase_resample",
    "resample_kernel",
    "sigmoid_confidence",
    "top_k_results",
    "apply_range_mask",
    "slice_overlapped_windows",
]

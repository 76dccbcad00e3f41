"""Polyphase resampling as dilated convolution.

The reference resamples on the host with a SIMD polyphase library
(internal/audiocore/resample/resample.go:45; github.com/tphakala/
go-audio-resampler). Here the batched device path expresses L/M rational
resampling as `lax.conv_general_dilated` with lhs_dilation=L and
window_strides=M — exactly the polyphase structure, compiled by XLA onto
the vector/matrix units with no host round-trip.

The bat 256 kHz "slow-down trick" needs *no* resample: raw 256 kHz PCM is fed
as if it were 48 kHz (reference: doc/wiki/detection-pipeline.md:103-117,
ModelSpec.RawSampleRate) — handled upstream by just not resampling.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Static rational-resample configuration (hashable, jit-static)."""

    in_rate: int
    out_rate: int
    taps_per_phase: int = 24     # filter half-quality; 24 ≈ "medium" quality
    beta: float = 8.6            # Kaiser window beta (~ -90 dB stopband)
    cutoff_scale: float = 0.97   # transition-band margin below Nyquist

    @property
    def ratio(self) -> tuple[int, int]:
        g = math.gcd(self.in_rate, self.out_rate)
        return self.out_rate // g, self.in_rate // g  # (L up, M down)

    def out_len(self, in_len: int) -> int:
        l, m = self.ratio
        return (in_len * l) // m


@functools.lru_cache(maxsize=32)
def _design_filter(l: int, m: int, taps_per_phase: int, beta: float,
                   cutoff_scale: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for L/M resampling, gain L, float32."""
    n_taps = 2 * taps_per_phase * max(l, m) + 1
    cutoff = cutoff_scale / max(l, m)          # normalized to the upsampled rate
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(n * cutoff) * cutoff
    h *= np.kaiser(n_taps, beta)
    h *= l / np.sum(h)                          # unity passband gain after ↑L
    return h.astype(np.float32)


def resample_kernel(cfg: ResampleConfig) -> jnp.ndarray:
    l, m = cfg.ratio
    return jnp.asarray(_design_filter(l, m, cfg.taps_per_phase, cfg.beta,
                                      cfg.cutoff_scale))


def polyphase_resample(x: jnp.ndarray, cfg: ResampleConfig) -> jnp.ndarray:
    """Rational resample [..., T] → [..., T·L/M].

    Implemented as one dilated conv: insert L−1 zeros (lhs_dilation), FIR
    low-pass, take every M-th output (window_strides). XLA lowers this to
    an implicit polyphase structure.
    """
    l, m = cfg.ratio
    if l == 1 and m == 1:
        return x
    h = resample_kernel(cfg)
    n_taps = h.shape[0]
    lead = x.shape[:-1]
    t = x.shape[-1]
    xf = x.reshape(-1, 1, t)                    # [N, C=1, W]
    # Center the filter: pad so output sample j corresponds to input j*M/L.
    # pad_hi is sized so the conv emits at least out_len samples:
    # output j reads dilated positions [j*M - pad_lo, j*M - pad_lo + n_taps).
    out_len = cfg.out_len(t)
    pad_lo = (n_taps - 1) // 2
    dilated_len = (t - 1) * l + 1
    pad_hi = max(n_taps - 1 - pad_lo,
                 (out_len - 1) * m + n_taps - pad_lo - dilated_len)
    out = jax.lax.conv_general_dilated(
        xf.astype(jnp.float32),
        h.reshape(1, 1, n_taps),
        window_strides=(m,),
        padding=[(pad_lo, pad_hi)],
        lhs_dilation=(l,),
        rhs_dilation=(1,),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :out_len].reshape(*lead, out_len)

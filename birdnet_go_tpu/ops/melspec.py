"""Mel-spectrogram front end in plain jax.numpy (two XLA routes for the DFT).

The reference's models embed their own spectrogram front ends inside the
TFLite/ONNX graphs (SURVEY.md §2.8 note; internal/classifier/analyze.go:61
feeds raw PCM). Here the front end is externalized so one op serves both
inference and live spectrogram rendering (reference north star;
internal/spectrogram/* uses SoX/FFmpeg subprocesses instead).

- framing: a static gather (indices precomputed at trace time — no dynamic
  shapes under jit);
- DFT, route chosen by `MelConfig.use_matmul_fft`:
  - True (default): a two-stage Cooley–Tukey *matmul* decomposition
    (radix split n_fft = A×B), O(n·(A+B)) per frame instead of the naive
    O(n²) DFT matmul; every stage is a float32 einsum at
    `Precision.HIGHEST`;
  - False: `jnp.fft.rfft` (cuFFT on the GPU);
- mel projection: one [n_bins → n_mels] matmul at the backend's default
  float32 precision (TF32 is allowed on GPUs that have it);
- log/power: elementwise, fused by XLA into the surrounding ops.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Static mel front-end configuration (hashable: safe as a jit static arg).

    Defaults correspond to the BirdNET v2.4 family contract: 48 kHz, 3 s
    windows (reference: internal/classifier/model_registry.go:137-200).
    The exact FFT/mel constants are model-specific and are carried alongside
    imported weights; these defaults are used by the native (from-scratch)
    model family.
    """

    sample_rate: int = 48000
    n_fft: int = 2048
    hop: int = 512
    n_mels: int = 96
    fmin: float = 0.0
    fmax: float = 15000.0
    window: str = "hann"           # "hann" | "hamming" | "rect"
    log_offset: float = 1e-6
    power: float = 2.0             # 2.0 = power spectrogram, 1.0 = magnitude
    use_matmul_fft: bool = True    # two-stage matmul DFT vs jnp.fft.rfft
    mag_scale: str = "log"         # "log" | "db" | "linear" | "nonlinear"

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.n_fft:
            return 0
        return (num_samples - self.n_fft) // self.hop + 1


def _window_fn(cfg: MelConfig) -> np.ndarray:
    n = cfg.n_fft
    if cfg.window == "hann":
        return np.hanning(n).astype(np.float32)
    if cfg.window == "hamming":
        return np.hamming(n).astype(np.float32)
    if cfg.window == "rect":
        return np.ones((n,), np.float32)
    raise ValueError(f"unknown window {cfg.window!r}")


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_np(sample_rate: int, n_fft: int, n_mels: int,
                       fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, [n_bins, n_mels], float32 (HTK-style)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return fb


def mel_filterbank(cfg: MelConfig) -> jnp.ndarray:
    return jnp.asarray(_mel_filterbank_np(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax))


def frame_signal(x: jnp.ndarray, cfg: MelConfig) -> jnp.ndarray:
    """[..., T] → [..., F, n_fft] overlapped frames via a static gather."""
    t = x.shape[-1]
    f = cfg.num_frames(t)
    if f <= 0:
        raise ValueError(f"signal of {t} samples shorter than n_fft={cfg.n_fft}")
    idx = (np.arange(f)[:, None] * cfg.hop + np.arange(cfg.n_fft)[None, :])
    return x[..., idx]


# ---------------------------------------------------------------------------
# Real DFT as two-stage matmuls (Cooley–Tukey n_fft = A×B decomposition).
#
# For x of length N = A*B laid out as x[a*B + b] (a-major time order):
#   X[k] = sum_a sum_b x[a*B+b] * W_N^{k(aB+b)}
#        = sum_b W_N^{kb} * ( sum_a x[a*B+b] * W_A^{(k mod A) a} )
# Stage 1 is an [A→A] DFT over the 'a' axis for each b (one A×A matmul).
# Stage 2 groups output bins by residue r = k mod A, writing k = r + A·j:
#   X[r + A·j] = sum_b s[r, b] · W_N^{(r+A·j) b}
# i.e. for each r a [B]×[B, J] matmul — a batched einsum with no
# materialized [K, B] intermediate. Cost per frame ≈ N·(A + B/2) mults vs
# N²/2 for the naive DFT matmul (16× fewer at N=2048), and every stage is a
# dense matrix product. Output lands in the permuted (r, j) layout; consumers either
# permute back (tests) or pre-permute the mel filterbank rows (melspec).
# ---------------------------------------------------------------------------


def _choose_radix(n: int) -> tuple[int, int]:
    """Pick A×B = n with A,B as close as possible (minimizes A+B)."""
    best = (1, n)
    a = int(math.isqrt(n))
    while a > 1:
        if n % a == 0:
            best = (a, n // a)
            break
        a -= 1
    return best


@functools.lru_cache(maxsize=16)
def _rdft_matmul_consts(n_fft: int):
    """Precompute DFT constants: stage-1 [A,A], stage-2 [A,B,J], bin map,
    for the FLOP-minimal radix split."""
    a_sz, b_sz = _choose_radix(n_fft)
    k_out = n_fft // 2 + 1
    j_sz = (k_out - 1) // a_sz + 1          # bins per residue group (padded)
    aa = np.arange(a_sz)
    w_a = np.exp(-2j * np.pi * np.outer(aa, aa) / a_sz)     # [A, A]
    r = np.arange(a_sz)[:, None, None]
    b = np.arange(b_sz)[None, :, None]
    j = np.arange(j_sz)[None, None, :]
    k = r + a_sz * j                                         # [A, 1, J]
    tw = np.exp(-2j * np.pi * (k * b) / n_fft)               # [A, B, J]
    # bin_of[r, j] = r + A*j, or -1 where it exceeds the spectrum
    bin_of = (np.arange(a_sz)[:, None] + a_sz * np.arange(j_sz)[None, :])
    valid = bin_of < k_out
    bin_of = np.where(valid, bin_of, -1)
    return (
        w_a.real.astype(np.float32), w_a.imag.astype(np.float32),
        tw.real.astype(np.float32), tw.imag.astype(np.float32),
        bin_of.astype(np.int64), a_sz, b_sz, j_sz,
    )


def _rdft_power_permuted(frames: jnp.ndarray, n_fft: int) -> jnp.ndarray:
    """frames [..., F, n_fft] → power spectrum [..., F, A, J] (r, j layout)."""
    war, wai, twr, twi, _, a_sz, b_sz, _ = _rdft_matmul_consts(n_fft)
    war = jnp.asarray(war); wai = jnp.asarray(wai)
    twr = jnp.asarray(twr); twi = jnp.asarray(twi)
    lead = frames.shape[:-1]
    x = frames.reshape(*lead, a_sz, b_sz)  # x[a, b], a-major time order
    dot = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    # Stage 1: DFT over 'a' for each b → s[r, b] complex.
    sr = dot("...ab,ar->...rb", x, war)
    si = dot("...ab,ar->...rb", x, wai)
    # Stage 2: per-residue matmul over b → X[r, j] complex.
    re = dot("...rb,rbj->...rj", sr, twr) - dot("...rb,rbj->...rj", si, twi)
    im = dot("...rb,rbj->...rj", sr, twi) + dot("...rb,rbj->...rj", si, twr)
    return re * re + im * im


def _rdft_power_matmul(frames: jnp.ndarray, n_fft: int) -> jnp.ndarray:
    """frames [..., F, n_fft] → power spectrum [..., F, n_fft//2+1] (k order).

    Reference/parity path: computes the permuted layout then scatters back to
    natural bin order. melspec avoids this permutation by permuting the mel
    filterbank instead.
    """
    *_, bin_of, a_sz, b_sz, j_sz = _rdft_matmul_consts(n_fft)
    p = _rdft_power_permuted(frames, n_fft)
    flat = p.reshape(*p.shape[:-2], a_sz * j_sz)
    # inverse permutation: k → (r, j) position
    k_out = n_fft // 2 + 1
    pos_of_k = np.zeros((k_out,), np.int64)
    rr, jj = np.nonzero(bin_of >= 0)
    pos_of_k[bin_of[rr, jj]] = rr * j_sz + jj
    return flat[..., pos_of_k]


def _spectrum(frames: jnp.ndarray, cfg: MelConfig) -> jnp.ndarray:
    """Windowed frames → power (or magnitude) spectrum [..., F, n_bins]."""
    win = jnp.asarray(_window_fn(cfg))
    fw = frames * win
    if cfg.use_matmul_fft:
        power = _rdft_power_matmul(fw, cfg.n_fft)
    else:
        spec = jnp.fft.rfft(fw, axis=-1)
        power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    if cfg.power == 2.0:
        return power
    return jnp.sqrt(jnp.maximum(power, 0.0)) ** cfg.power


@functools.lru_cache(maxsize=32)
def _mel_filterbank_permuted_np(sample_rate: int, n_fft: int, n_mels: int,
                                fmin: float, fmax: float) -> np.ndarray:
    """Mel filterbank with rows permuted into the (r, j) DFT output layout.

    fb_perm[r·J + j, m] = fb[r + A·j, m] (0 for padded positions), so
    melspec can consume the permuted spectrum directly — the layout
    permutation is absorbed into a constant matrix instead of a gather.
    """
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, fmin, fmax)
    *_, bin_of, a_sz, b_sz, j_sz = _rdft_matmul_consts(n_fft)
    out = np.zeros((a_sz * j_sz, n_mels), np.float32)
    rr, jj = np.nonzero(bin_of >= 0)
    out[rr * j_sz + jj] = fb[bin_of[rr, jj]]
    return out


def melspec(x: jnp.ndarray, cfg: MelConfig) -> jnp.ndarray:
    """PCM float32 [..., T] → mel spectrogram [..., F, n_mels].

    Jittable; all shapes static given (T, cfg). The same op feeds model
    inference and spectrogram PNG rendering (shared-kernel requirement).
    """
    frames = frame_signal(x, cfg)
    if cfg.use_matmul_fft and cfg.power == 2.0:
        # Fused fast path: permuted-layout matmul DFT + permuted filterbank.
        win = jnp.asarray(_window_fn(cfg))
        p = _rdft_power_permuted(frames * win, cfg.n_fft)
        p = p.reshape(*p.shape[:-2], -1)
        fb = jnp.asarray(_mel_filterbank_permuted_np(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax))
    else:
        p = _spectrum(frames, cfg)
        fb = mel_filterbank(cfg)
    mel = jnp.einsum("...fk,km->...fm", p, fb,
                     preferred_element_type=jnp.float32)
    if cfg.mag_scale == "log":
        return jnp.log(mel + cfg.log_offset)
    if cfg.mag_scale == "db":
        return 10.0 * jnp.log10(mel + cfg.log_offset)
    if cfg.mag_scale == "nonlinear":
        # BirdNET-style nonlinear magnitude compression: x^(1/(1+e)) with
        # e≈0.3 approximates the perceptual scaling used by bird CNN fronts.
        return jnp.power(jnp.maximum(mel, 0.0), 1.0 / 1.3)
    return mel

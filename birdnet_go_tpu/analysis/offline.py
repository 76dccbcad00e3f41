"""Offline file analysis: WAV → windows → batched device inference → table.

Behavior spec: doc/wiki/file-analysis.md (the reference's legacy `file`
command, absent from the snapshot's cmd/ but required). Batched shape:
the whole file becomes fixed-size window batches, each batch one device
step — a 120 s soundscape is 79 windows at default overlap, i.e. ONE step,
vs the reference's serial per-window TFLite invokes (~8 s on a Pi).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from birdnet_go_tpu.analysis.results import Detection, WindowResult
from birdnet_go_tpu.audio.wav import read_wav
from birdnet_go_tpu.inference.backend import Classifier
from birdnet_go_tpu.ops.resample import ResampleConfig, polyphase_resample
from birdnet_go_tpu.ops.windows import window_hop_samples
from birdnet_go_tpu.taxonomy.labels import LabelSet


@dataclasses.dataclass
class OfflineConfig:
    threshold: float = 0.8          # conf/defaults.go:77 global default
    sensitivity: float = 1.0        # conf/defaults.go:76
    overlap: float = 0.0            # seconds on the 3 s base (cmd/root.go:96)
    batch_size: int = 64            # windows per device step (static shape)
    top_k: int = 10
    all_results: bool = False       # emit all top-K above threshold per window


@dataclasses.dataclass
class OfflineReport:
    detections: list[Detection]
    windows: list[WindowResult]
    duration_seconds: float
    elapsed_seconds: float

    @property
    def realtime_factor(self) -> float:
        return self.duration_seconds / max(self.elapsed_seconds, 1e-9)


class OfflineAnalyzer:
    """Analyze files/arrays with one classifier."""

    def __init__(self, classifier: Classifier, labels: LabelSet,
                 config: OfflineConfig | None = None):
        self.classifier = classifier
        self.labels = labels
        self.config = config or OfflineConfig()
        spec = classifier.model.spec
        self.clip_samples = spec.clip_samples
        self.model_rate = spec.sample_rate
        self.clip_seconds = spec.clip_seconds

    def analyze_file(self, path: str | Path) -> OfflineReport:
        samples, info = read_wav(path)
        return self.analyze_samples(samples, info.sample_rate)

    def analyze_samples(self, samples: np.ndarray, sample_rate: int
                        ) -> OfflineReport:
        t_start = time.perf_counter()
        cfg = self.config
        duration = len(samples) / sample_rate

        if sample_rate != self.model_rate:
            rcfg = ResampleConfig(sample_rate, self.model_rate)
            samples = np.asarray(polyphase_resample(
                jnp.asarray(samples, jnp.float32), rcfg))
        samples = np.asarray(samples, np.float32)

        hop = window_hop_samples(self.clip_samples, cfg.overlap,
                                 self.model_rate,
                                 clip_seconds=self.clip_seconds)
        windows = self._host_slice(samples, self.clip_samples, hop)
        n_win = windows.shape[0]

        window_results: list[WindowResult] = []
        detections: list[Detection] = []
        b = cfg.batch_size
        for start in range(0, n_win, b):
            chunk = windows[start:start + b]
            if chunk.shape[0] < b:       # pad to the static batch shape
                pad = np.zeros((b - chunk.shape[0], self.clip_samples),
                               np.float32)
                chunk = np.concatenate([chunk, pad], axis=0)
            vals, idx = self.classifier.predict_topk(
                chunk, sensitivity=cfg.sensitivity, k=cfg.top_k)
            for j in range(min(b, n_win - start)):
                w = start + j
                begin = w * hop / self.model_rate
                end = begin + self.clip_seconds
                wr = WindowResult(
                    window_index=w, begin_seconds=begin, end_seconds=end,
                    model_id=self.classifier.model_id,
                    indices=[int(i) for i in idx[j]],
                    confidences=[float(v) for v in vals[j]])
                window_results.append(wr)
                detections.extend(self._detections_for(wr))

        elapsed = time.perf_counter() - t_start
        return OfflineReport(detections=detections, windows=window_results,
                             duration_seconds=duration,
                             elapsed_seconds=elapsed)

    def _detections_for(self, wr: WindowResult) -> list[Detection]:
        cfg = self.config
        out = []
        for conf, sp_idx in zip(wr.confidences, wr.indices):
            if conf < cfg.threshold:
                break                    # top-K is sorted descending
            sp = self.labels[sp_idx]
            out.append(Detection(
                species=sp, confidence=conf,
                begin_seconds=wr.begin_seconds, end_seconds=wr.end_seconds,
                model_id=wr.model_id, window_index=wr.window_index,
                species_code=self.labels.code_for(sp)))
            if not cfg.all_results:
                break                    # top-1 per window (Raven default)
        return out

    @staticmethod
    def _host_slice(samples: np.ndarray, clip: int, hop: int) -> np.ndarray:
        """[T] → [W, clip] overlapped windows (zero-padded tail), zero-copy
        views via stride tricks, final copy only at batch assembly."""
        t = len(samples)
        if t < clip:
            out = np.zeros((1, clip), np.float32)
            out[0, :t] = samples
            return out
        n_full = (t - clip) // hop + 1
        rem = t - ((n_full - 1) * hop + clip)
        w = n_full + (1 if rem > 0 else 0)
        if rem > 0:
            padded = np.zeros(((w - 1) * hop + clip,), np.float32)
            padded[:t] = samples
            samples = padded
        sv = np.lib.stride_tricks.sliding_window_view(samples, clip)[::hop]
        return sv[:w]

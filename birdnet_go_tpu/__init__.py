"""birdnet_go_tpu — a JAX bioacoustic analysis framework (GPU or CPU).

A from-scratch JAX/XLA rebuild of the capabilities of BirdNET-Go
(reference: tphakala/birdnet-go): realtime + offline bird/bat sound
identification with multi-model consensus, geographic range filtering,
detection persistence and a serving API, batched for an accelerator.

Layering (bottom-up), mirroring the reference layer map (SURVEY.md §1):

- ``ops``        — device numerics: fused audio front end (PCM→f32, polyphase
                   resample, overlapped window slicing, STFT/mel), sigmoid/top-K
                   post-processing.
- ``models``     — model families re-expressed as jitted JAX graphs: BirdNET
                   v2.4, BirdNET v3.0, Google Perch v2, BattyBirdNET bat
                   two-stage, Geomodel range filters.
- ``inference``  — weight import (.tflite flatbuffers / .onnx protos → param
                   pytrees), orbax checkpoints, the Classifier protocol
                   (reference: internal/inference/backend.go).
- ``audio``      — host pipeline: sources, ring buffers with the reference's
                   exact overlapped-window semantics, router w/ drop accounting
                   (reference: internal/audiocore).
- ``scheduler``  — the batched device loop: packs ready windows from N streams
                   × M models into fixed-shape megabatches each tick.
- ``analysis``   — detection engine: thresholds, dynamic thresholds, range
                   filter gating, cross-model consensus, Deep Detection,
                   actions + job queue (reference: internal/analysis/processor).
- ``datastore``  — SQLite persistence of detections/reviews/analytics.
- ``api``        — REST/SSE serving layer (reference: internal/api/v2).
- ``parallel``   — device meshes, shardings, multi-chip serve/train paths.
- ``train``      — custom-classifier training (optax) with dp/tp shardings.
"""

from birdnet_go_tpu.version import __version__

__all__ = ["__version__"]

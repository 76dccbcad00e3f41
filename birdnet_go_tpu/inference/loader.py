"""Model construction + weight resolution.

Weight order of precedence (reference analogue: embedded model bytes →
external model path, internal/classifier/birdnet.go:314-402):
1. explicit checkpoint path (orbax, produced by the importers/training),
2. installed model dir ``<model_home>/<model_id>`` ($BIRDNET_TPU_MODELS,
   default ./data/models — populated by `model install` / importers),
3. deterministic random init (clearly warned: pipeline-testable, not
   field-accurate — the data-free analogue of the reference's `noembed`
   test builds).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any

import jax

from birdnet_go_tpu.models.bat import BatClassifier
from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
from birdnet_go_tpu.models.birdnet_v3 import BirdNETv3
from birdnet_go_tpu.models.geomodel import Geomodel, GeomodelConfig
from birdnet_go_tpu.models.perch_v2 import PerchV2

log = logging.getLogger("birdnet_tpu.inference")

_MODELS_ENV = "BIRDNET_TPU_MODELS"
_DEFAULT_MODEL_HOME = "./data/models"

def _lazy_bsg(**kwargs):
    from birdnet_go_tpu.models.bsg import BSGFinland

    return BSGFinland(**kwargs)


_FAMILIES = {
    "BirdNET_V2.4": BirdNETv24,
    "BirdNET_V3.0": BirdNETv3,
    "Perch_V2": PerchV2,
    "BattyBirdNET": BatClassifier,
    "BSG": _lazy_bsg,
}


def model_home() -> Path:
    return Path(os.environ.get(_MODELS_ENV, _DEFAULT_MODEL_HOME))


def build_model(model_id: str, **kwargs) -> Any:
    try:
        return _FAMILIES[model_id](**kwargs)
    except KeyError:
        raise KeyError(f"unknown model family {model_id!r}; "
                       f"known: {sorted(_FAMILIES)}") from None


class ImportedModel:
    """Adapter exposing an imported .tflite/.onnx graph through the native
    model interface (spec/num_species/apply) so JaxClassifier and the
    scheduler treat converted models exactly like native ones."""

    def __init__(self, graph, model_id: str):
        from birdnet_go_tpu.models.registry import MODEL_REGISTRY, ModelSpec

        self.graph = graph
        base = MODEL_REGISTRY.get(model_id)
        self._probe_species(graph)
        if base is not None:
            self.spec = base
            if self.num_species is None:
                self.num_species = base.num_species
        else:
            # keep num_species a real int even when probing failed —
            # predict_topk does min(k, num_species) and None would crash
            self.num_species = self.num_species or 0
            self.spec = ModelSpec(
                model_id=model_id, display_name=model_id,
                sample_rate=48000, clip_seconds=3.0,
                num_species=self.num_species)

    def _probe_species(self, graph) -> None:
        self.num_species = None
        try:
            if hasattr(graph, "model"):         # tflite
                out = graph.model.tensors[graph.model.outputs[0]]
                if out.shape:
                    self.num_species = int(out.shape[-1])
            elif hasattr(graph, "graph"):       # onnx (shapes not in proto
                # value_info: trace the classifier head's weight instead)
                self.num_species = self._probe_onnx_species(graph.graph)
        except Exception:
            pass

    @staticmethod
    def _probe_onnx_species(g) -> int | None:
        """Walk back from the graph output through shape-preserving ops to
        the final Gemm/MatMul and read the head width off its weight."""
        producers = {o: n for n in g.nodes for o in n.outputs}
        passthrough = {"Softmax", "LogSoftmax", "Sigmoid", "Relu",
                       "Identity", "Reshape", "Flatten", "Squeeze",
                       "Unsqueeze", "Add", "Cast"}
        name = g.outputs[0]
        for _ in range(20):
            n = producers.get(name)
            if n is None:
                return None
            if n.op_type == "Gemm" and len(n.inputs) > 1:
                w = g.initializers.get(n.inputs[1])
                if w is not None:
                    trans_b = int(n.attrs.get("transB", 0) or 0)
                    return int(w.shape[0] if trans_b else w.shape[-1])
                return None
            if n.op_type == "MatMul" and len(n.inputs) > 1:
                w = g.initializers.get(n.inputs[1])
                return int(w.shape[-1]) if w is not None else None
            if n.op_type in passthrough and n.inputs:
                name = n.inputs[0]
                continue
            return None
        return None

    def init(self, key):
        return self.graph.params

    def apply(self, params, pcm, train: bool = False):
        outs = self.graph.apply(params, pcm)
        logits = outs[0]
        emb = outs[1] if len(outs) > 1 else logits
        return {"logits": logits, "embedding": emb}

    def __call__(self, params, pcm, train: bool = False):
        return self.apply(params, pcm, train)


def load_model(model_id: str, checkpoint: str | None = None, seed: int = 0,
               **kwargs) -> tuple[Any, Any]:
    """Returns (model, params). `checkpoint` may be an orbax dir, a
    .tflite flatbuffer, or a .onnx proto (imported via the converters)."""
    from birdnet_go_tpu.inference.checkpoint import load_params

    if checkpoint and str(checkpoint).endswith(".tflite"):
        from birdnet_go_tpu.inference.tflite_import import load_tflite

        g = load_tflite(checkpoint)
        model = ImportedModel(g, model_id)
        log.info("imported %s from tflite %s", model_id, checkpoint)
        return model, g.params
    if checkpoint and str(checkpoint).endswith(".onnx"):
        from birdnet_go_tpu.inference.onnx_import import load_onnx

        g = load_onnx(checkpoint)
        model = ImportedModel(g, model_id)
        log.info("imported %s from onnx %s", model_id, checkpoint)
        return model, g.params

    installed = model_home() / model_id
    if not checkpoint and installed.is_dir() and any(installed.iterdir()):
        # gallery-installed artifacts take precedence: model.tflite/.onnx
        for name in ("model.tflite", "model.onnx"):
            artifact = installed / name
            if artifact.is_file():
                return load_model(model_id, checkpoint=str(artifact),
                                  seed=seed, **kwargs)

    model = build_model(model_id, **kwargs)
    if checkpoint:
        params = load_params(checkpoint)
        log.info("loaded %s weights from %s", model_id, checkpoint)
        return model, params
    if installed.is_dir() and any(installed.iterdir()):
        params = load_params(installed)
        log.info("loaded %s weights from %s", model_id, installed)
        return model, params
    log.warning(
        "no weights for %s (no checkpoint given, nothing installed under "
        "%s) — using deterministic random init; detections will NOT be "
        "field-accurate", model_id, model_home())
    return model, model.init(jax.random.PRNGKey(seed))


def apply_serving_options(model, realtime) -> None:
    """Apply config-driven serving options to a freshly loaded model.

    `realtime.act_int8` flips the int8 activation-boundary path on
    mel-CNN families (models/base.py `act_int8`). Models without the knob — imported
    .tflite/.onnx graphs, the geomodel — are left untouched."""
    if getattr(realtime, "act_int8", False) and hasattr(model, "act_int8"):
        model.act_int8 = True
        log.info("act_int8 serving path enabled for %s",
                 getattr(model.spec, "model_id", type(model).__name__))


def geomodel_weights_installed(checkpoint: str | None = None) -> bool:
    """True when load_geomodel would serve trained weights rather than
    deterministic random init (whose scores are plausible-looking
    nonsense — callers presenting range-filter output to a user must
    surface that)."""
    if checkpoint:
        return True
    installed = model_home() / "Geomodel"
    return installed.is_dir() and any(installed.iterdir())


def load_geomodel(checkpoint: str | None = None, num_species: int = 6522,
                  seed: int = 7) -> tuple[Geomodel, Any]:
    from birdnet_go_tpu.inference.checkpoint import load_params

    g = Geomodel(GeomodelConfig(num_species=num_species))
    if checkpoint:
        return g, load_params(checkpoint)
    installed = model_home() / "Geomodel"
    if installed.is_dir() and any(installed.iterdir()):
        return g, load_params(installed)
    log.warning("no geomodel weights — using deterministic random init")
    return g, g.init(jax.random.PRNGKey(seed))

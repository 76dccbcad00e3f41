"""chip_smoke.py rehearsed on the CPU at tiny size.

The script refuses a CPU-only host, so each phase function is driven here
with a tiny model (the phases take the model as an argument); on the GPU
`python chip_smoke.py` runs them at full width.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tiny(compute_dtype=jnp.bfloat16, n=24):
    from birdnet_go_tpu.models.birdnet_v24 import BirdNETv24
    from birdnet_go_tpu.models.efficientnet import (
        BlockSpec,
        EfficientNetConfig,
    )
    from birdnet_go_tpu.ops.melspec import MelConfig

    m = BirdNETv24(num_species=n,
                   mel=MelConfig(sample_rate=48000, n_fft=256, hop=8192,
                                 n_mels=16, mag_scale="nonlinear"),
                   compute_dtype=compute_dtype)
    m.net = EfficientNetConfig(blocks=(BlockSpec(1, 8, 3, 2, 1),),
                               embedding_dim=16, num_classes=n)
    return m


@pytest.fixture()
def tiny_loader(monkeypatch):
    """Route load_model (CLI analyze and Application) to the tiny model."""
    from birdnet_go_tpu.inference import loader
    import birdnet_go_tpu.app as app_mod

    def load(model_id, checkpoint=None, seed=0, **kw):
        m = _tiny()
        return m, m.init(jax.random.PRNGKey(seed))

    monkeypatch.setattr(loader, "load_model", load)
    monkeypatch.setattr(app_mod, "load_model", load)


def test_smoke_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_fails_without_the_repo(tmp_path):
    """Copied into an empty directory the script exits non-zero and prints
    no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_reference_tiny():
    import chip_smoke

    m = _tiny()
    params = m.init(jax.random.PRNGKey(0))
    res = chip_smoke.phase_reference(m, _tiny(jnp.float32), params,
                                     batch=4, seed=0)
    assert set(res["frontend"]) == {"matmul", "rfft"}
    assert res["confidences"]["max_conf_delta"] < chip_smoke.TOL_CONF


def test_phase_reference_catches_a_wrong_step():
    """A reference that disagrees (other weights) fails the gate."""
    import chip_smoke

    m = _tiny()
    params = m.init(jax.random.PRNGKey(0))
    other = _tiny(jnp.float32)
    wrong = jax.tree_util.tree_map(lambda x: -x, params)
    pcm = chip_smoke.make_windows(4, m.spec.clip_samples, 48000, 0)

    class Flipped:
        spec = other.spec
        num_species = other.num_species

        def apply(self, p, x):
            return other.apply(wrong, x)

    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_confidences(m, Flipped(), params, pcm)


def test_phase_offline_tiny(tmp_path, tiny_loader):
    import chip_smoke

    res = chip_smoke.phase_offline(tmp_path, seed=1, seconds=10.5)
    assert res["rows"] == 4
    assert Path(res["wav"]).is_file()


def test_phase_served_tiny(tmp_path, tiny_loader):
    import threading

    import chip_smoke

    wav = tmp_path / "w.wav"
    from birdnet_go_tpu.audio.wav import write_wav

    write_wav(wav, chip_smoke.make_audio(6.0, 48000, 3), 48000)
    before = {t.ident for t in threading.enumerate()}
    res = chip_smoke.phase_served(tmp_path, str(wav), max_batch=8,
                                  timeout_s=60)
    assert res["detections"] > 0 and res["windows"] > 0
    assert res["warmup_s"] is not None
    left = [t for t in threading.enumerate()
            if t.ident not in before and not t.daemon]
    assert not left, f"non-daemon threads left running: {left}"


def test_phase_timings_tiny():
    import chip_smoke

    m = _tiny()
    params = m.init(jax.random.PRNGKey(0))
    res = chip_smoke.phase_timings(m, params, batches=(4,), iters=2,
                                   card="cpu")
    assert res[4]["step"]["step_ms_p50"] > 0
    assert set(res[4]["frontend_ms"]) == {"matmul", "rfft"}


def test_phase_four_cards_on_virtual_devices():
    """ModelBatcher/DeviceLoop over ShardedClassifier on a 2×2 mesh of
    virtual CPU devices equals the one-device step."""
    import chip_smoke

    assert len(jax.devices()) >= 4
    m = _tiny()
    params = m.init(jax.random.PRNGKey(0))
    res = chip_smoke.phase_four_cards(m, params, batch=8, seed=2)
    assert res["topk_overlap"] == 1.0
    assert res["max_conf_delta"] < 1e-5


def test_make_audio_is_seeded():
    import chip_smoke

    a = chip_smoke.make_audio(1.0, 48000, 5)
    assert a.dtype == np.int16 and a.shape == (48000,)
    np.testing.assert_array_equal(a, chip_smoke.make_audio(1.0, 48000, 5))
    assert not np.array_equal(a, chip_smoke.make_audio(1.0, 48000, 6))


def test_result_line_contract(monkeypatch, capsys):
    """With every phase stubbed, main() ends with the exact result line."""
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(chip_smoke, "phase_device", lambda: Dev())
    import bench

    monkeypatch.setattr(bench, "card_name_and_power",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase_reference", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "phase_offline",
                        lambda *a, **k: {"wav": "x"})
    monkeypatch.setattr(chip_smoke, "phase_served", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "phase_timings", lambda *a, **k: {})
    import birdnet_go_tpu.models.birdnet_v24 as v24

    small = _tiny()
    monkeypatch.setattr(v24, "BirdNETv24", lambda **kw: small)
    assert chip_smoke.main(["--out", "unused"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": len(jax.devices())}}

"""Regression tests for the fifth self-review batch: device-loop dict
races, runtime model locale/overlap, app robustness (malformed sources,
per-source lifecycle isolation, range-filter guards), train dataset tail
batches, and native list framing."""

from __future__ import annotations

import numpy as np


def test_device_loop_snapshot_iteration():
    """run_tick/drain iterate a snapshot so API threads can add/remove
    batchers mid-tick without RuntimeError."""
    from birdnet_go_tpu.scheduler.loop import DeviceLoop

    loop = DeviceLoop()

    class _B:
        class spec:
            model_id = "m1"
        max_batch = 4

        def __init__(self, loop):
            self._loop = loop

        def dispatch(self):
            # mutate the dict DURING iteration (as a runtime unload would)
            self._loop.batchers.pop("m2", None)
            return 0

        def harvest(self):
            self._loop.batchers.pop("m2", None)
            return 0

    class _B2(_B):
        class spec:
            model_id = "m2"

    loop.batchers["m1"] = _B(loop)
    loop.batchers["m2"] = _B2(loop)
    loop.run_tick()            # must not raise
    loop.batchers["m2"] = _B2(loop)
    loop.drain()               # must not raise


def test_dataset_batches_small_dataset_still_trains():
    from birdnet_go_tpu.train.dataset import WindowDataset

    ds = WindowDataset(
        windows=np.zeros((12, 100), np.float32),
        labels=np.array([0, 1, 2] * 4),
        class_names=["a", "b", "c"])
    batches = list(ds.batches(batch_size=16, epochs=2))
    assert len(batches) == 2                      # one short batch per epoch
    assert all(len(x) == 12 for x, y in batches)
    # larger datasets keep FULL batches only (a ragged tail would add a
    # second XLA graph shape → a recompile)
    batches = list(ds.batches(batch_size=5, epochs=1))
    assert [len(x) for x, _ in batches] == [5, 5]


def test_add_source_from_config_guards_missing_keys():
    from birdnet_go_tpu.app import Application
    from birdnet_go_tpu.config.settings import Settings

    app = Application.__new__(Application)
    app.engine = None
    app._sources = []
    app._source_cfgs = {}
    app.settings = Settings()
    assert app._add_source_from_config({"type": "file"}) is None
    assert app._add_source_from_config({"type": "rtsp"}) is None
    assert app._add_source_from_config({"type": "http", "id": "x"}) is None
    assert app._sources == []


def test_range_scores_batch_does_not_mutate_caller():
    from birdnet_go_tpu.app import Application

    app = Application.__new__(Application)
    calls = []

    class _RF:
        def predict_batch(self, coords):
            calls.append(coords.copy())
            return np.zeros((len(coords), 3), np.float32)

    app._range_filter = _RF()
    app.labels = {"m": ["a"] * 3}
    grid = np.array([[60.0, 24.0, -1.0], [61.0, 25.0, 7.0]], np.float32)
    before = grid.copy()
    app.range_filter_scores_batch(grid)
    np.testing.assert_array_equal(grid, before)   # sentinel survives
    assert calls[0][0, 2] > 0                      # default week filled in


def test_alsa_device_list_sanitizes_desc_newlines():
    """DESC hints embed newlines; the name\\tdesc\\n framing must survive.
    Exercised through the C++ writer contract: a desc with a newline comes
    back as a single record."""
    from birdnet_go_tpu.native import lib as native

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")
    # the C++ sanitation is exercised live only with ALSA present; the
    # Python parser must at least keep one record per line
    recs = native.alsa_list_devices()
    for r in recs:
        assert "\n" not in r["name"] and "\n" not in r.get("description", "")

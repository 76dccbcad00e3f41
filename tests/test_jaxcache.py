"""Compile-cache location and the imports the device path needs."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_sets_nothing(restore_cache_dir):
    from birdnet_go_tpu.utils.jaxcache import enable_compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    got = enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert got == "/some/cache"
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_defaults_into_checkout(restore_cache_dir):
    from birdnet_go_tpu.utils.jaxcache import enable_compile_cache

    got = enable_compile_cache({})
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_cache_dir_is_fixed(restore_cache_dir):
    """The default names no pid, time or temporary directory, so every
    process of this checkout finds the same cache."""
    import os
    import tempfile

    from birdnet_go_tpu.utils.jaxcache import enable_compile_cache

    a = enable_compile_cache({})
    b = enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": ""})
    assert a == b
    assert str(os.getpid()) not in a
    assert not a.startswith(tempfile.gettempdir())


def test_cli_main_sets_the_cache_dir(restore_cache_dir, monkeypatch):
    from birdnet_go_tpu.cli.main import main

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    main(["gen-schema"])
    assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")


def test_device_path_imports_no_optional_packages():
    """Importing the served and offline paths pulls in none of the
    packages a bare accelerator host may lack."""
    code = (
        "import sys\n"
        "import birdnet_go_tpu.app, birdnet_go_tpu.cli.main\n"
        "import birdnet_go_tpu.analysis.processor, bench, chip_smoke\n"
        "bad = [m for m in ('yaml', 'aiohttp', 'httpx', 'orbax', 'PIL')\n"
        "       if m in sys.modules]\n"
        "print(','.join(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_http_client_defers_httpx_until_first_use():
    from birdnet_go_tpu.utils.httpclient import HttpClient

    c = HttpClient()
    assert c._session is None
    c.close()                           # nothing to close yet
    s = c.session
    assert s is c.session and c._session is s
    c.close()

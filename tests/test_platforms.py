"""
The platform-to-path module (pyshepseg_tpu/platforms.py), the device
memory budgets built on it, the compile-cache setup, the CONC_SUBPROC
worker environment, and chip_smoke.py's refusal to run without a card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pyshepseg_tpu import io as rio
from pyshepseg_tpu import platforms, tiling, tilingstats, utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_supported_platforms_map_to_a_stats_engine(platform):
    assert platforms.checkPlatform(platform) == platform
    assert platforms.statsEngine(platform) in ("host", "device")


@pytest.mark.parametrize("platform", ["rocm", "neuron", "METAL"])
def test_other_platforms_raise(platform):
    with pytest.raises(platforms.UnsupportedPlatformError):
        platforms.checkPlatform(platform)
    with pytest.raises(platforms.UnsupportedPlatformError):
        platforms.statsEngine(platform)


def test_current_platform_is_cpu_here():
    assert platforms.currentPlatform() == "cpu"
    assert platforms.statsEngine() == "host"


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_budget_from_bytes_limit():
    dev = _FakeDevice({"bytes_limit": 80 << 30, "bytes_in_use": 0})
    assert platforms.deviceMemoryBudget(0.25, dev) == 20 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_device_memory_budget_without_limit_uses_host(monkeypatch, stats):
    monkeypatch.setattr(platforms, "hostAvailableBytes", lambda: 8 << 30)
    assert platforms.deviceMemoryBudget(0.5, _FakeDevice(stats)) == 4 << 30


@pytest.mark.parametrize("limit,fits", [(80 << 30, True), (1 << 20, False)])
def test_budgets_follow_memory_stats(monkeypatch, tmp_path, limit, fits):
    """The stats scene feed and the segmentation scene cache both size
    their budget from the device's bytes_limit."""
    import jax
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice({"bytes_limit": limit})])
    monkeypatch.setattr(platforms, "hostAvailableBytes", lambda: 64 << 30)
    assert tilingstats._sceneFitsDeviceStats(2000, 2000, 4) is fits

    path = str(tmp_path / "scene.npseg")
    ds = rio.create(path, 2000, 2000, 4, np.uint16)
    ds.FlushCache()
    del ds
    assert tiling.DeviceSceneCache.fitsOnDevice(rio.open(path),
                                                [1, 2, 3, 4]) is fits


def test_setup_compilation_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert utils.setupCompilationCache() == str(tmp_path)
    # nothing else is set: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_setup_compilation_cache_default_is_checkout(monkeypatch):
    import jax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = utils.setupCompilationCache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_subproc_env_on_cpu_is_unchanged():
    env = {"A": "1"}
    assert tiling.subprocWorkerEnv(0, 2, [], env) == env


def test_subproc_env_gives_each_worker_its_own_card():
    envs = [tiling.subprocWorkerEnv(i, 4, ["0", "1", "2", "3"], {})
            for i in range(4)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    # the parent keeps JAX's default 0.75 of every card
    assert {e["XLA_PYTHON_CLIENT_MEM_FRACTION"] for e in envs} == {"0.2000"}


def test_subproc_env_shares_a_card_explicitly():
    env = {"XLA_PYTHON_CLIENT_MEM_FRACTION": "0.25"}
    envs = [tiling.subprocWorkerEnv(i, 3, ["5"], env) for i in range(3)]
    assert {e["CUDA_VISIBLE_DEVICES"] for e in envs} == {"5"}
    shares = [float(e["XLA_PYTHON_CLIENT_MEM_FRACTION"]) for e in envs]
    assert shares == [pytest.approx(0.7 / 3, abs=1e-4)] * 3
    assert sum(shares) + 0.25 <= 1.0


def test_subproc_env_refuses_too_small_a_share():
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.subprocWorkerEnv(0, 64, ["0"], {})


def _runChipSmoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_on_cpu():
    res = _runChipSmoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _runChipSmoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

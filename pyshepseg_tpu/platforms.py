"""
The one module that maps the JAX platform the program runs on to the
paths it takes there, and that sizes device-memory budgets.

Two platforms are supported: ``"cpu"`` (the test suite and hosts
without a card) and ``"gpu"`` (NVIDIA cards through JAX's CUDA
plugin). Any other platform is an error, never a default.
"""

SUPPORTED_PLATFORMS = ("cpu", "gpu")

# What tilingstats' engine='auto' resolves to on each platform. On the
# CPU the "device" is the host itself, so the vectorised numpy engine
# wins. On an H100 the device engine's warm call beat the host's by
# ~0.1-0.2 s on the golden 8000^2 segmentation, but its first call
# compiled for ~18 s, so the host engine is faster for a run of a few
# stats passes (PERF.md, bring-up findings).
_STATS_ENGINE = {"cpu": "host", "gpu": "host"}

# Memory budget used when the backend reports no device memory limit
# (the CPU backend, whose arrays live in host RAM) and /proc/meminfo is
# unreadable.
DEFAULT_BUDGET_BYTES = 1 << 30


class UnsupportedPlatformError(RuntimeError):
    """The JAX platform is neither "cpu" nor "gpu"."""


def checkPlatform(platform):
    """Return ``platform`` if it is supported, else raise
    :class:`UnsupportedPlatformError`."""
    if platform not in SUPPORTED_PLATFORMS:
        raise UnsupportedPlatformError(
            f"JAX platform {platform!r} is not supported; expected one "
            f"of {SUPPORTED_PLATFORMS}")
    return platform


def currentPlatform():
    """The platform of JAX's default device, checked."""
    import jax
    return checkPlatform(jax.devices()[0].platform)


def statsEngine(platform=None):
    """'host' or 'device': the stats compaction engine that
    engine='auto' picks on ``platform`` (default: the current one)."""
    if platform is None:
        platform = currentPlatform()
    return _STATS_ENGINE[checkPlatform(platform)]


def hostAvailableBytes():
    """MemAvailable from /proc/meminfo, or 0 when unreadable."""
    try:
        with open('/proc/meminfo') as f:
            for line in f:
                if line.startswith('MemAvailable:'):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def deviceMemoryBudget(fraction, device=None):
    """
    ``fraction`` of the memory ``device`` (default: JAX's first device)
    may hold, in bytes: its ``memory_stats()["bytes_limit"]`` when the
    backend reports one. The CPU backend reports none; its arrays
    compete with everything else in host RAM, so the budget is a
    fraction of the host's available memory instead.
    """
    if device is None:
        import jax
        device = jax.devices()[0]
    try:
        limit = (device.memory_stats() or {}).get('bytes_limit', 0)
    except Exception:
        limit = 0
    if not limit:
        limit = hostAvailableBytes() or DEFAULT_BUDGET_BYTES
    return int(limit * fraction)

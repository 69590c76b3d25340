"""Process set-up shared by the measurement scripts (bench.py,
chip_smoke.py, benchmarks/tick_backends.py): the compile cache, the device
check and the card's name and power limit."""

from __future__ import annotations

import os
import shutil
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR if set, else the fixed <repo>/.jax_cache
    (a fixed path: the cache key includes it, so a moving directory never
    hits)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The devices of the GPU backend; raises RuntimeError when JAX's
    default backend is anything else (a measurement never falls back)."""
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's default backend is {platform!r}")
    return jax.devices()


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """`name, power.limit` of every card as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()

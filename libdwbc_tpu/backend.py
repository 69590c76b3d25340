"""The one place that picks the WBC tick that serves on a platform.

cpu and gpu both serve CompiledTick, the batch-major XLA formulation
(MaskedTick where the contact set is a per-call mask).  On the H100 it was
the only formulation that compiled in a serving budget: FusedTick's
element-leading program, as one XLA graph or as one Triton kernel, did not
finish compiling within 420 s (PERF.md, Findings).  Any other platform
raises: there is no fallback.  Called when a tick is built, never at
import.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PLATFORMS = ("cpu", "gpu")


def serving_tick(model, cfg, dtype=jnp.float32, masked: bool = False,
                 platform: str | None = None):
    """The tick for `platform` (default: JAX's default backend)."""
    from .wbc.masked import MaskedTick
    from .wbc.pipeline import CompiledTick

    platform = jax.default_backend() if platform is None else platform
    if platform not in PLATFORMS:
        raise RuntimeError(f"no WBC tick for platform {platform!r}")
    return (MaskedTick if masked else CompiledTick)(model, cfg, dtype=dtype)

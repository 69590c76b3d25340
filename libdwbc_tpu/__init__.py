"""libdwbc-tpu: batched whole-body control for floating-base humanoids.

Operational-space WBC (OSF-HQP), reduced-dimension contact-consistent
dynamics, and acceleration-level lexicographic QP cascades as a compiler +
batched kernel engine on JAX/XLA, with a native C++ host runtime.

Entry points:
  RobotData            — reference-compatible controller facade
  CompiledTick         — fused single-graph control tick (batch/shard ready)
  backend.serving_tick — the tick that serves on this platform
  RobotModel           — compiled model artifact (URDF → static arrays)
  RlWBCBridge          — RL environment bridge (single + batched)
"""

__version__ = "0.1.0"

# Exact float32 matmuls.  On the GPU, XLA may run a float32 dot or einsum
# on the tensor cores in TF32, which keeps about three decimal digits.  For
# control math that is not acceptable: the mass-matrix and jacobian
# products feed a Cholesky-based contact space and QPs, which amplify
# input rounding into torque errors far above the 1e-2 Nm at which exact
# f32 agrees with f64 truth (chip_smoke.py checks it on the card).  So the
# package pins float32 precision globally; CPU results are unaffected.
# Opt out with DWBC_ALLOW_BF16_MATMUL=1 only for
# throughput experiments whose outputs you do not act on.
import os as _os

if _os.environ.get("DWBC_ALLOW_BF16_MATMUL", "0") != "1":
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", "float32")

from .model.compile import (  # noqa: F401
    JointSpec, LinkSpec, RobotModel, compile_from_links, compile_urdf,
)
from .wbc import types  # noqa: F401
from .wbc.pipeline import CompiledTick, PipelineConfig, standard_tocabi_config  # noqa: F401
from .wbc.reduced_tick import ReducedTick  # noqa: F401
from .wbc.robot import RobotData  # noqa: F401

__all__ = [
    "RobotData",
    "RobotModel",
    "CompiledTick",
    "ReducedTick",
    "PipelineConfig",
    "standard_tocabi_config",
    "compile_urdf",
    "compile_from_links",
    "LinkSpec",
    "JointSpec",
    "types",
]

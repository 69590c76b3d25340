"""The one tick-selection function, the compile-cache helper, and the
device checks of the measurement scripts."""

import numpy as np
import pytest


@pytest.mark.parametrize("platform,masked,want", [
    ("cpu", False, "CompiledTick"),
    ("cpu", True, "MaskedTick"),
    ("gpu", False, "CompiledTick"),
    ("gpu", True, "MaskedTick"),
    ("rocm", False, RuntimeError),
    ("metal", False, RuntimeError),
])
def test_serving_tick_selection(platform, masked, want, tocabi_npz):
    import jax.numpy as jnp

    from libdwbc_tpu import backend
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    cfg = standard_tocabi_config(tocabi_npz, qp_iters=4)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no WBC tick for platform"):
            backend.serving_tick(tocabi_npz, cfg, masked=masked,
                                 platform=platform)
        return
    tick = backend.serving_tick(tocabi_npz, cfg, dtype=jnp.float32,
                                masked=masked, platform=platform)
    assert type(tick).__name__ == want
    assert tick.dtype == jnp.float32


def test_selection_at_construction(monkeypatch):
    """_model_and_tick asks the selection function each time a tick is
    built (here: the default backend is read then, not at import), and an
    unknown platform raises instead of falling back."""
    import jax

    import __graft_entry__ as ge

    model, tick = ge._model_and_tick(qp_iters=4)
    assert type(tick).__name__ == "CompiledTick"
    assert model.ndof == 39
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no WBC tick for platform"):
        ge._model_and_tick(qp_iters=4)


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    import jax

    from libdwbc_tpu import runtime

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = f"{runtime.REPO_ROOT}/.jax_cache"
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert runtime.compile_cache_dir() == want
    old = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_require_gpu_refuses_cpu():
    from libdwbc_tpu import runtime

    with pytest.raises(RuntimeError, match="needs a GPU"):
        runtime.require_gpu()
    assert runtime.device_info()["platform"] == "cpu"


@pytest.mark.gpu
def test_gpu_selection_on_card(gpu):
    """On the card, the default tick is the measured choice."""
    import __graft_entry__ as ge

    assert gpu.platform == "gpu"
    _, tick = ge._model_and_tick(qp_iters=4)
    assert type(tick).__name__ == "CompiledTick"


@pytest.mark.gpu
def test_matmul_pin_on_card(gpu):
    """An f32 matmul on the card keeps f32 accuracy under the package's
    precision pin; TF32 would keep ~3 decimal digits."""
    import jax
    import jax.numpy as jnp

    import libdwbc_tpu  # noqa: F401  (sets the pin)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 64)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(jax.device_put(a, gpu),
                                         jax.device_put(b, gpu)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()

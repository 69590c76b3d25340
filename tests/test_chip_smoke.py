"""chip_smoke.py's phases at a tiny batch on the CPU, its refusal to run
without a GPU, and its --four-cards path on 4 virtual CPU devices.

The phases are generic over the tick; here they drive CompiledTick, the
serving tick on both platforms."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def tick32(tocabi_npz):
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    return CompiledTick(tocabi_npz, standard_tocabi_config(tocabi_npz, qp_iters=12),
                        dtype=jnp.float32)


def test_phase_truth(tick32, tocabi_npz):
    dg, dc = cs.phase_truth(tick32, tocabi_npz, n=2)
    assert dg < cs.TOL_GRAV and dc < cs.TOL_CMD


def test_phase_pin(tocabi_npz):
    import jax

    assert jax.config.jax_default_matmul_precision == "float32"
    dg, _ = cs.phase_pin(tocabi_npz, n=2)
    assert dg < cs.TOL_GRAV


def test_phase_compile_and_latency(tick32, tocabi_npz):
    compiled = cs.phase_compile(tick32, tocabi_npz, batches=(3, 1))
    assert set(compiled) == {3, 1}
    p50, p99 = cs.phase_latency(compiled, n_calls=3)
    assert 0 < p50 <= p99


def test_phase_warm_chain(tick32, tocabi_npz):
    sps = cs.phase_warm_chain(tick32, tocabi_npz, B=2, K=3)
    assert np.isfinite(sps) and sps > 0


def test_phase_loop(tick32, tocabi_npz):
    per_tick = cs.phase_loop(tick32, tocabi_npz, n_ticks=3)
    assert per_tick > 0


def test_main_refuses_without_gpu(tmp_path):
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, cs.__file__], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_alone_without_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("masked", [False, True])
def test_four_card_path_on_virtual_devices(masked):
    """sharded_parity (the --four-cards path, static contacts; masked for
    dryrun_multichip) on 4 of the virtual CPU devices: mesh by reshape,
    shard_map step, cross-device argmin, one-device comparison."""
    import jax

    import __graft_entry__ as ge

    assert len(jax.devices()) >= 4
    r = ge.sharded_parity(4, qp_iters=4, per_device=2, masked=masked)
    assert r["mesh"] == {"hyp": 2, "roll": 2}
    assert r["tick"] == ("MaskedTick" if masked else "CompiledTick")
    assert r["max_abs_diff"] < 1e-2
    assert 0 <= r["best"] < 8

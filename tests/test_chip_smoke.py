"""chip_smoke.py's refusals and its compile-cache choice, on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench_suite
import chip_smoke
from spt_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench_suite.require_gpu(jax.devices())


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, compile_cache.DEFAULT_DIR),
    ({}, compile_cache.DEFAULT_DIR),
])
def test_cache_dir_follows_environment(env, expected):
    assert compile_cache.cache_dir(env) == expected
    assert compile_cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


def test_smoke_fails_without_gpu():
    out = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert "[0 device] FAILED" in out.stdout
    assert not _printed_result(out.stdout)


def test_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


def test_main_path_has_no_low_precision_matmul():
    """The SoA forward, its gradient and the megakernel hold no matrix
    product that the GPU could run in TF32."""
    sd = bench_suite.cornell(ggx=True).compile()
    kw = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=3)
    assert chip_smoke.main_path_matmuls(
        sd, bench_suite.cornell_camera(), 16, 16, kw) == (0, 0)


def test_matmul_audit_sees_default_precision():
    """The audit counts a plain f32 product inside a scan as low precision
    and one with precision=HIGHEST as fine."""
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST

    def f(a):
        def body(c, _):
            return (c @ a) + jnp.dot(c, a, precision=hi), None
        return jax.lax.scan(body, a, None, length=2)[0]

    assert chip_smoke.low_precision_matmuls(f, jnp.eye(3)) == (2, 1)


def test_four_card_phase_on_cpu_mesh():
    """The --four-cards phase, rehearsed on four virtual CPU devices at a
    small size: every sharded strategy agrees with one device."""
    notes = []
    chip_smoke.phase_four_cards(notes, size=(48, 28), n_spheres=300,
                                grad_size=16)
    assert len(notes) == 5 and "make_dp_grad_step" in notes[-1]

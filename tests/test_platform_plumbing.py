"""Platform plumbing: the device mesh, native builds, peak tables and the
GPU-only entry points."""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from advancedvi_jl_tpu.ops import native_build
from advancedvi_jl_tpu.parallel.mesh import DATA_AXIS, MC_AXIS, make_vi_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_large  # noqa: E402


@pytest.mark.parametrize("n_data,n_mc", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_mesh_is_a_plain_reshape_of_the_devices(n_data, n_mc):
    devices = jax.devices()[:8]
    mesh = make_vi_mesh(n_mc=n_mc, n_data=n_data, devices=devices)
    assert mesh.axis_names == (DATA_AXIS, MC_AXIS)
    assert mesh.devices.shape == (n_data, n_mc)
    assert list(mesh.devices.reshape(-1)) == list(devices)


def test_mesh_keeps_a_given_device_order():
    devices = list(reversed(jax.devices()[:4]))
    mesh = make_vi_mesh(n_mc=4, devices=devices)
    assert list(mesh.devices.reshape(-1)) == devices


@pytest.mark.parametrize("n_data,n_mc", [(3, None), (2, 3)])
def test_mesh_refuses_a_shape_that_does_not_fit(n_data, n_mc):
    with pytest.raises(ValueError):
        make_vi_mesh(n_mc=n_mc, n_data=n_data, devices=jax.devices()[:8])


@pytest.fixture
def src(tmp_path):
    p = tmp_path / "k.cc"
    p.write_text('extern "C" int avt_probe() { return 7; }\n')
    return str(p)


def test_library_path_is_keyed_by_source_and_flags(src):
    a = native_build.library_path(src, ["-O2", "-shared", "-fPIC"])
    assert a == native_build.library_path(src, ["-O2", "-shared", "-fPIC"])
    assert a != native_build.library_path(src, ["-O3", "-shared", "-fPIC"])
    with open(src, "a") as fh:
        fh.write("// edited\n")
    assert a != native_build.library_path(src, ["-O2", "-shared", "-fPIC"])
    assert os.path.dirname(a) == native_build.build_dir()
    assert native_build.build_dir() == os.path.join(REPO, "build", "native")


def test_build_once_then_reuse(src):
    import ctypes

    flags = ["-O2", "-shared", "-fPIC"]
    out = native_build.build_shared_library(src, flags)
    try:
        assert os.path.exists(out)
        assert ctypes.CDLL(out).avt_probe() == 7
        mtime = os.path.getmtime(out)
        assert native_build.build_shared_library(src, flags) == out
        assert os.path.getmtime(out) == mtime
    finally:
        os.remove(out)


def test_build_failure_raises_and_leaves_nothing(tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    flags = ["-shared", "-fPIC"]
    with pytest.raises(subprocess.CalledProcessError):
        native_build.build_shared_library(str(bad), flags)
    assert not os.path.exists(native_build.library_path(str(bad), flags))


def test_repo_libraries_are_not_built_into_the_sources():
    from advancedvi_jl_tpu.ops.native_ffi import ffi_available
    from advancedvi_jl_tpu.utils.data import native_available

    assert native_available() and ffi_available()
    cpp = os.path.join(REPO, "advancedvi_jl_tpu", "ops", "cpp")
    assert not [f for f in os.listdir(cpp) if f.endswith(".so")]


def test_peak_table_knows_the_h100():
    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    pk = bench_large.peaks_for(dev)
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["tf32_flops"] == 495e12 and pk["fp32_flops"] == 67e12


def test_peak_table_refuses_an_unknown_device():
    with pytest.raises(KeyError, match="no peak table"):
        bench_large.peaks_for(jax.devices("cpu")[0])


@pytest.mark.parametrize("script", ["bench.py", "bench_large.py"])
def test_benchmarks_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "not a GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_no_tpu_module_is_importable():
    import importlib

    for mod in ("advancedvi_jl_tpu.ops.pallas",
                "advancedvi_jl_tpu.ops.pallas.fused_advi"):
        with pytest.raises(ImportError):
            importlib.import_module(mod)


@pytest.mark.gpu
def test_gpu_sampler_matches_cpu(gpu_device):
    """On a card: the XLA samplers draw the same base normals as the CPU
    and agree with it at full float32 matmul precision."""
    import jax.numpy as jnp

    import advancedvi_jl_tpu as avt

    d, n = 130, 256
    cpu = jax.devices("cpu")[0]
    q = avt.FullRankGaussian(jnp.zeros(d), jnp.eye(d) * 0.5)
    key = jax.random.key(0)
    with jax.default_matmul_precision("highest"):
        zg, ug = jax.jit(lambda q, k: q.sample_with_base(k, n))(
            *jax.device_put((q, key), gpu_device))
        zc, uc = jax.jit(lambda q, k: q.sample_with_base(k, n))(
            *jax.device_put((q, key), cpu))
    assert zg.devices() == {gpu_device}
    np.testing.assert_allclose(np.asarray(ug), np.asarray(uc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(zg), np.asarray(zc), rtol=1e-5,
                               atol=1e-5)

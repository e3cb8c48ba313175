"""The parts of chip_smoke.py that run without a GPU.

The script itself refuses the CPU; its helpers (tolerances, the nvidia-smi
parser, the result line, the compile-cache choice) and its phases at tiny
sizes, with the CPU standing in for both devices, are checked here.  The
four-device comparison runs on four virtual CPU devices.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from advancedvi_jl_tpu.utils.compile_cache import (  # noqa: E402
    CACHE_ENV,
    enable_compile_cache,
)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_refuses_cpu_before_any_phase(args):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        capture_output=True, text=True, env=_cpu_env(), cwd=REPO, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "phase" not in r.stdout
    assert "not a GPU" in r.stderr


def test_refuses_in_a_directory_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_main_exits_on_cpu_in_process():
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code == 2


@pytest.mark.parametrize(
    "a,b,want",
    [
        (np.ones(3), np.ones(3), 0.0),
        (np.array([1.0, 2.0]), np.array([1.0, 4.0]), 0.5),
        (np.array([0.0, 1e-3]), np.array([0.0, 0.0]), 1e-3),
        ({"x": np.ones(2), "y": np.full(2, 10.0)},
         {"x": np.zeros(2), "y": np.full(2, 10.0)}, 0.1),
    ],
)
def test_rel_diff(a, b, want):
    assert cs.rel_diff(a, b) == pytest.approx(want)


def test_rel_diff_needs_matching_trees():
    with pytest.raises(ValueError, match="leaves"):
        cs.rel_diff({"x": np.ones(2)}, {"x": np.ones(2), "y": np.ones(2)})


def test_check_prints_and_raises(capsys):
    cs.check("close", 1e-6, 1e-5, "highest")
    out = capsys.readouterr().out
    assert "close: 1.000e-06 (tol 1e-05, highest) ok" in out
    with pytest.raises(cs.SmokeFailure, match="far"):
        cs.check("far", 1e-3, 1e-5, "default")
    assert "FAIL" in capsys.readouterr().out
    with pytest.raises(cs.SmokeFailure):
        cs.check("nan", float("nan"), 1.0, "default")


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W",
         [("NVIDIA H100 80GB HBM3", 700.0)]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", 500.0), ("NVIDIA H100 80GB HBM3", 700.0)]),
        ("Vendor, Model X, 350 W", [("Vendor, Model X", 350.0)]),
    ],
)
def test_parse_nvidia_smi(text, want):
    assert cs.parse_nvidia_smi(text) == want


@pytest.mark.parametrize("text", ["no comma here", "NVIDIA H100, [N/A]"])
def test_parse_nvidia_smi_refuses_garbage(text):
    with pytest.raises(ValueError):
        cs.parse_nvidia_smi(text)


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_environment(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "env_cache"))
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "env_cache")
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path,
                                        restore_cache_dir):
    monkeypatch.delenv(CACHE_ENV, raising=False)
    want = os.path.join(str(tmp_path), ".jax_cache")
    assert enable_compile_cache(str(tmp_path)) == want
    assert jax.config.jax_compilation_cache_dir == want
    # the same checkout always gets the same path
    assert enable_compile_cache(str(tmp_path) + os.sep) == want


def test_two_runs_from_one_checkout_share_the_cache(tmp_path):
    script = f"""
import logging, sys
sys.path.insert(0, {REPO!r})
import jax, jax.numpy as jnp
logging.basicConfig(level=logging.WARNING)
logging.getLogger("jax._src.compiler").setLevel(logging.DEBUG)
from advancedvi_jl_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache({str(tmp_path)!r}))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(5)))
"""
    env = _cpu_env()
    env.pop(CACHE_ENV, None)
    runs = [
        subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=300)
        for _ in range(2)
    ]
    for r in runs:
        assert r.returncode == 0, r.stderr
        assert r.stdout.splitlines()[0] == str(tmp_path / ".jax_cache")
    assert "cache hit for 'jit__lambda'" not in runs[0].stderr
    assert "cache hit for 'jit__lambda'" in runs[1].stderr
    assert os.listdir(tmp_path / ".jax_cache")


def _cpu():
    return jax.devices("cpu")[0]


def test_phase_flagship_tiny():
    cs.phase_flagship(_cpu(), _cpu(), steps=40, log_every=10, n_data=32,
                      n_features=3)


def test_phase_fullrank_tiny():
    cs.phase_fullrank(_cpu(), _cpu(), d=8, n_samples=8, steps=3)


def test_phase_bnn_tiny():
    cs.phase_bnn(_cpu(), _cpu(), n_data=64, in_dim=3, hidden=4, batch=16,
                 n_samples=2, steps=6, n_compare=3)


def test_phase_measure_space_tiny():
    cs.phase_measure_space(_cpu(), _cpu(), d=6, steps=3, n_samples=8)


def test_multi_phase_on_four_virtual_devices(capsys):
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    cs.phase_multi(devices, flagship_steps=30, n_data=32, n_features=3,
                   fr_d=16, fr_samples=32, fr_steps=3, small_d=8)
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'mc': 4}" in out
    assert out.count(" ok") == 10 and "FAIL" not in out


def test_multi_phase_fails_on_a_missed_tolerance(monkeypatch):
    monkeypatch.setattr(cs, "TOL_MULTI", -1.0)
    with pytest.raises(cs.SmokeFailure):
        cs.phase_multi(jax.devices("cpu")[:4], flagship_steps=5, n_data=16,
                       n_features=2, fr_d=8, fr_samples=8, fr_steps=1,
                       small_d=4)

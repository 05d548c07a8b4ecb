"""Process set-up and the card-only entry points, checked on the CPU: the
benchmark's peaks table, the compile cache directory, nvidia-smi parsing,
mesh sizing, and that chip_smoke.py and bench.py refuse to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
from yoloq.parallel import mesh as pmesh
from yoloq.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestPeaks:
    def test_h100_sxm(self):
        p = bench.peaks_for("NVIDIA H100 80GB HBM3")
        assert p["int8_ops"] == 1979e12
        assert p["bf16_flops"] == 989e12
        assert p["hbm_bytes_per_s"] == 3.35e12

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
    def test_unknown_kind_raises(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.peaks_for(kind)


class TestCompileCache:
    def test_dir_from_environment(self):
        assert runtime.compile_cache_dir({runtime.CACHE_ENV: "/x/cache"}) == "/x/cache"

    def test_dir_defaults_to_checkout(self):
        want = os.path.join(REPO, "build", "jax_cache")
        assert runtime.compile_cache_dir({}) == want
        assert runtime.compile_cache_dir({runtime.CACHE_ENV: ""}) == want

    def test_setup_sets_nothing_when_env_set(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.setenv(runtime.CACHE_ENV, "/x/cache")
        assert runtime.setup_compile_cache() == "/x/cache"
        assert calls == []

    def test_setup_points_jax_at_checkout_cache(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
        path = runtime.setup_compile_cache()
        assert path == runtime.DEFAULT_CACHE_DIR
        assert calls == [("jax_compilation_cache_dir", runtime.DEFAULT_CACHE_DIR)]
        assert os.path.isdir(path)


class TestNvidiaSmi:
    @pytest.mark.parametrize(
        "line,name,watts",
        [
            ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
            ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3", 500.0),
            ("NVIDIA H200, 650 W", "NVIDIA H200", 650.0),
        ],
    )
    def test_parse_name_power(self, line, name, watts):
        assert runtime.parse_name_power(line) == (name, watts)

    def test_device_report_names_the_platform(self):
        rep = runtime.device_report()
        assert rep["platform"] == "cpu" and rep["count"] == len(jax.devices())
        if shutil.which("nvidia-smi") is None:
            assert rep["nvidia_smi"] == []


class TestMeshSizing:
    def test_device_pool_raises_when_short(self):
        n = len(jax.devices())
        assert len(pmesh.device_pool(n)) == n
        with pytest.raises(ValueError, match="need"):
            pmesh.device_pool(n + 1)

    def test_make_mesh_raises_when_short(self):
        with pytest.raises(ValueError, match="need"):
            pmesh.make_mesh(n_data=len(jax.devices()), n_model=2)

    def test_dryrun_raises_when_short(self):
        import __graft_entry__

        with pytest.raises(ValueError, match="need"):
            __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


class TestNeedsAGpu:
    def test_chip_smoke_fails_on_cpu(self):
        out = _run_cpu(["chip_smoke.py"], REPO)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
        assert "no GPU" in out.stderr

    def test_chip_smoke_fails_alone(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        out = _run_cpu(["chip_smoke.py"], str(tmp_path))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

    def test_bench_fails_on_unknown_device(self):
        out = _run_cpu(["bench.py"], REPO)
        assert out.returncode != 0
        assert "no published peaks" in out.stderr
        assert "images/sec" not in out.stdout

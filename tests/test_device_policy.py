"""Device policy: the smoke test refuses to run without a GPU, the
roofline table knows the card and nothing else, the compile cache lands
where JAX_COMPILATION_CACHE_DIR or the checkout says, the CLIs select
cpu|gpu, and no module imports the TPU Pallas backend."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo, the script has no library to drive."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_roofline_knows_h100():
    from bmsparse.utils.roofline import device_hbm_gbps

    assert device_hbm_gbps(_Dev("NVIDIA H100 80GB HBM3")) == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_roofline_refuses_unknown_device(kind):
    from bmsparse.utils.roofline import device_hbm_gbps

    with pytest.raises(ValueError, match="no published memory bandwidth"):
        device_hbm_gbps(_Dev(kind))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from bmsparse.config import compile_cache_dir

    monkeypatch.delenv("BMSP_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from bmsparse.config import compile_cache_dir

    monkeypatch.delenv("BMSP_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == str(ROOT / ".jax_cache")
    monkeypatch.setenv("BMSP_NO_COMPILE_CACHE", "1")
    assert compile_cache_dir() is None


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", True),
                                         ("tpu", False)])
def test_cli_platform_choices(platform, ok):
    from bmsparse.cli.spmv import build_parser

    argv = ["data/real", "A_matrix", "--platform", platform]
    if ok:
        assert build_parser().parse_args(argv).platform == platform
    else:
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)


def test_no_tpu_pallas_backend_imports():
    offenders = [
        str(p.relative_to(ROOT))
        for p in (ROOT / "bmsparse").rglob("*.py")
        if "pallas.tpu" in p.read_text() or "pallas import tpu"
        in p.read_text()
    ]
    assert offenders == []

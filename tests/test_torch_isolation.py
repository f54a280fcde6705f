"""Isolation and hygiene of the PyTorch port (`src/repro_torch/` and the
root `chip_smoke.py`): it imports neither `jax` nor the JAX package
`repro`, every module imports with JAX unavailable, its serving and
training launchers run end to end on the CPU, its entry points default to
CUDA, and it lints clean under tools/repro_lint."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v}\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35


def test_launch_serve_bench_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--bench"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[continuous] prefill" in out.stdout and "(4 slots, cpu)" in out.stdout


def test_launch_train_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "2"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step      2  loss" in out.stdout and "final loss:" in out.stdout


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_entry_points_default_to_cuda(entry):
    from repro_torch.launch import serve, train
    from repro_torch.train.loop import TrainConfig
    from repro_torch.utils.device import resolve_device

    assert TrainConfig().device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    main = {"serve": serve.main, "train": train.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA requested"):
        main(["--smoke", "--bench"] if entry == "serve" else ["--smoke"])


def test_port_lints_clean():
    from tools.repro_lint import lint_paths

    findings, errors = lint_paths([str(PORT), str(REPO / "chip_smoke.py")])
    assert not errors and not findings, [f.to_json() for f in findings] + errors


def test_build_keeps_the_ptxas_report_of_a_cached_library(tmp_path, monkeypatch):
    """`BUILD_LOGS` is filled on a fresh build and again when the library
    is loaded from the build directory (nvcc and the loader are faked: no
    compiler here)."""
    from repro_torch.kernels import build

    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    report = "ptxas info    : Used 24 registers\n"
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")
        return subprocess.CompletedProcess(cmd, 0, "", report)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    lib = build.load_cuda_library("k", [src])
    assert build.BUILD_LOGS["k"] == report and len(calls) == 1
    build.BUILD_LOGS.clear()
    assert build.load_cuda_library("k", [src]) == lib
    assert build.BUILD_LOGS["k"] == report and len(calls) == 1

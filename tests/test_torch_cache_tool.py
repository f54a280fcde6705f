"""tools/torch_cache_dataset.py (the port's cache builder) against
tools/cache_dataset.py (the reference's): the same arguments give the
same files, byte for byte, and print the same lines, the fingerprint
among them. Small builds: image streams, LM streams, a Dirichlet split of
a pooled synthetic corpus and of an on-disk .npz corpus; then a rebuild
with the same arguments that touches nothing, and a conflicting one that
is refused alike.
"""
import contextlib
import importlib.util
import io
import os
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF, PORT = _tool("cache_dataset"), _tool("torch_cache_dataset")

CASES = {
    "image": ["--kind", "image", "--num-clients", "3", "--examples-per-client", "40",
              "--shard-size", "16", "--image-size", "8", "--alpha", "0.3"],
    "lm": ["--kind", "lm", "--num-clients", "3", "--examples-per-client", "24",
           "--shard-size", "10", "--seq-len", "16", "--vocab-size", "32"],
    "dirichlet": ["--kind", "image", "--num-clients", "4", "--examples-per-client", "30",
                  "--image-size", "8", "--dirichlet-alpha", "0.3", "--seed", "2"],
    "corpus": ["--num-clients", "3", "--dirichlet-alpha", "0.5", "--shard-size", "8"],
}


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _run(tool, cache, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tool.main(["--cache-dir", str(cache), *args, "--fingerprint"])
    return buf.getvalue().replace(str(cache), "<dir>")


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_files_and_fingerprint(case, tmp_path):
    args = list(CASES[case])
    if case == "corpus":
        rng = np.random.default_rng(4)
        path = tmp_path / "corpus.npz"
        np.savez(path, label=rng.integers(0, 5, 90).astype(np.int32),
                 image=rng.normal(size=(90, 6)).astype(np.float32))
        args += ["--corpus", str(path)]
    want = _run(REF, tmp_path / "ref", args)
    got = _run(PORT, tmp_path / "port", args)
    assert got == want and "fingerprint " in got
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and len(ref_files) > 1
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    # a rebuild with the same arguments touches nothing
    stamp = {n: os.stat(tmp_path / "port" / n).st_mtime_ns for n in port_files}
    assert _run(PORT, tmp_path / "port", args) == want
    assert {n: os.stat(tmp_path / "port" / n).st_mtime_ns for n in port_files} == stamp


def test_conflicting_rebuild_refused_alike(tmp_path):
    args = CASES["lm"]
    _run(REF, tmp_path / "ref", args)
    _run(PORT, tmp_path / "port", args)
    other = [*args[:-2], "--vocab-size", "64"]
    errs = []
    for tool, d in ((REF, "ref"), (PORT, "port")):
        with pytest.raises(Exception) as e:
            _run(tool, tmp_path / d, other)
        errs.append((type(e.value).__name__, str(e.value).replace(str(tmp_path / d), "<dir>")))
    assert errs[0] == errs[1]

"""Each cell of BENCHMARK.json end to end at the program's smoke sizes on
the CPU: one contract line, `correct` true in float32 (where the program
and the reference compute the same function), and the per-layer metrics
a CPU trace can give."""
import json

import pytest
import torch

from perfbench.tests import smoke

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.mark.parametrize("name", smoke.workloads())
def test_cell_prints_one_contract_line(name):
    w = smoke.cell(name)
    rc, line, err = smoke.run(w)
    assert rc == 0, err
    assert KEYS <= set(line) and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in w["end_to_end"]}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values() if m["unit"] != "GiB")
    assert line["device"]["platform"] == "cpu"
    for name_, c in line["compared"].items():
        assert f"{name_} {c['value']!r} limit {c['limit']!r}" in err


@pytest.mark.parametrize("name", smoke.workloads())
def test_traced_run_reports_only_per_layer_metrics(name):
    w = smoke.cell(name)
    rc, line, err = smoke.run(w, trace=True)
    assert rc == 0, err
    assert line["correct"] is True
    allowed = {m["name"] for m in w["per_layer"]}
    assert set(line["metrics"]) <= allowed
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, str(smoke.ROOT / "perfbench" / "run.py"),
                           "--workload", smoke.workloads()[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=smoke.ROOT, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_run_refuses_in_a_bare_checkout(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone has no program."""
    import shutil
    import subprocess
    import sys

    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(smoke.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           smoke.workloads()[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
    json.loads((tmp_path / "BENCHMARK.json").read_text())


DESCRIBE = {"arch", "source", "reduced", "published", "assumed", "departs", "note"}


@pytest.mark.parametrize("conf", json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
                         ["configs"], ids=lambda c: c["name"])
def test_configuration_file_states_its_cuts_and_departures(conf):
    """A configuration file sets the program's fields and describes itself:
    each key cut is in BENCHMARK.json's `reduced` with its published value,
    and each departure from the release names both values."""
    from perfbench.lib import bench

    cfg = json.loads((smoke.ROOT / conf["file"]).read_text())
    assert set(cfg) <= DESCRIBE | set(bench.MODEL_FIELDS), set(cfg) - DESCRIBE
    assert cfg["reduced"] == conf["reduced"]
    for key in cfg["reduced"]:
        assert key in cfg and cfg["published"][key] != cfg[key]
    for key, entry in cfg.get("departs", {}).items():
        assert key == "why" or {"release", "here"} <= set(entry), key
    bench.model_config(cfg)  # the program takes every field

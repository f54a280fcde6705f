"""The port launcher's systems flags (`--prefetch`, `--async`,
`--sync-every`, `--staleness-decay`, `--max-staleness`,
`--sim-ms-per-sample`, `--client-chunk`, `--data`, `--cache-dir`,
`--dirichlet-alpha`, `--cache-examples`, `--vectorized-data`) against the
reference launcher's.

Both launchers run with their `train` replaced by a stub that records the
TrainConfig and the first round batch: the defaults and the parsed values
of every flag reach the same TrainConfig fields (and topology
`sync_every`) in both, and the first batch is byte-equal (synthetic,
vectorized, cached and Dirichlet-cached; the port builds its cache on
first use, and the reference reads that cache). The refusals give the
reference's messages: a chunk that does not divide M, `--async` with
`--client-chunk`, `--data cached` without `--cache-dir`, and a `--mesh`
whose client-shard count does not divide M.
"""
import numpy as np
import pytest

import repro.launch.train as jax_launch
import repro_torch.launch.train as launch

FIELDS = ("prefetch", "async_mode", "staleness_decay", "max_staleness",
          "time_per_sample_s", "client_chunk", "steps", "local_steps")


class _Stop(Exception):
    pass


def _capture(module, monkeypatch):
    seen = {}

    def fake_train(model, opt, batches, tcfg, M, **kw):
        seen["tcfg"], seen["batch"] = tcfg, next(iter(batches))
        raise _Stop

    monkeypatch.setattr(module, "train", fake_train)
    return seen


def _both(argv, monkeypatch):
    got_j, got = _capture(jax_launch, monkeypatch), _capture(launch, monkeypatch)
    with pytest.raises(_Stop):
        jax_launch.main(["--smoke"] + argv)
    with pytest.raises(_Stop):
        launch.main(["--smoke", "--device", "cpu"] + argv)
    return got_j, got


def _same(got_j, got):
    for f in FIELDS:
        assert getattr(got["tcfg"], f) == getattr(got_j["tcfg"], f), f
    tj, t = got_j["tcfg"].topology, got["tcfg"].topology
    assert (tj is None) == (t is None)
    if t is not None:
        assert (t.name, t.sync_every, t.attach) == (tj.name, tj.sync_every, tj.attach)
    for k, v in got_j["batch"].items():
        assert np.asarray(v).tobytes() == np.asarray(got["batch"][k]).tobytes(), k


def test_defaults_match_reference(monkeypatch):
    got_j, got = _both([], monkeypatch)
    _same(got_j, got)
    assert got["tcfg"].prefetch == 2 and got["tcfg"].async_mode is False


@pytest.mark.parametrize("argv", [
    ["--prefetch", "1", "--async", "--staleness-decay", "0.5",
     "--max-staleness", "3", "--sim-ms-per-sample", "2.5",
     "--topology", "multi-server", "--sync-every", "3"],
    ["--prefetch", "0", "--client-chunk", "1", "--vectorized-data"],
])
def test_flags_reach_the_same_config(argv, monkeypatch):
    got_j, got = _both(argv, monkeypatch)
    _same(got_j, got)


@pytest.mark.parametrize("extra", [[], ["--dirichlet-alpha", "0.3"]])
def test_cached_data_built_on_first_use(extra, monkeypatch, tmp_path):
    argv = ["--prefetch", "0", "--data", "cached", "--cache-dir",
            str(tmp_path / "c"), "--cache-examples", "24"] + extra
    got = _capture(launch, monkeypatch)
    with pytest.raises(_Stop):
        launch.main(["--smoke", "--device", "cpu"] + argv)
    assert (tmp_path / "c" / "manifest.json").is_file()
    got_j = _capture(jax_launch, monkeypatch)
    with pytest.raises(_Stop):  # the reference reads the port's cache
        jax_launch.main(["--smoke"] + argv)
    _same(got_j, got)


@pytest.mark.parametrize("argv,match", [
    (["--client-chunk", "2"], "must divide the client count"),
    (["--async", "--client-chunk", "1"], "--async is incompatible"),
    (["--data", "cached"], "requires --cache-dir"),
])
def test_refusals_match_reference(argv, match, monkeypatch):
    for module, base in ((jax_launch, ["--smoke"]),
                         (launch, ["--smoke", "--device", "cpu"])):
        _capture(module, monkeypatch)
        with pytest.raises(SystemExit, match=match):
            module.main(base + argv)
    # --mesh is ported: on the smoke config (M = 3) a data=2 mesh is
    # refused with the reference's divisibility message
    # (tests/test_torch_mesh_launch.py runs a real --mesh)
    for module, base in ((jax_launch, ["--smoke"]),
                         (launch, ["--smoke", "--device", "cpu"])):
        _capture(module, monkeypatch)
        with pytest.raises(SystemExit, match="which must divide the client count: 3 % 2"):
            module.main(base + ["--mesh", "data=2"])

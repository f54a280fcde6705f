"""The port's training launcher on the MoE archs against the reference's,
with the same argv, as tests/test_torch_lm_launch.py holds the dense, ssm
and hybrid LMs: both registries' mtsl `init_state` return the reference's
`PRNGKey(seed)` draw (carried across with `params_from_jax`), each package
draws its own byte-identical batches, and the histories must agree entry
for entry (step, round and participants exactly, the loss within 1e-5).
The VLM and encoder-decoder archs are refused: their batches carry vision
features or audio frames that the LM source does not draw, as in the
reference launcher. The serving launcher, which once refused the moe, vlm
and encdec families, serves them; it refuses `--engine continuous` for
the vlm and encdec families (no chunked prefill) with the reference's
message.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.launch.train import main as jax_main
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core.mtsl import TrainState
from repro_torch.launch.train import main
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_map

ARGVS = {
    "deepseek-moe-sgd": ["--arch", "deepseek-moe-16b", "--steps", "3", "--seq-len",
                         "32", "--optimizer", "sgd", "--lr", "0.1",
                         "--batch-per-client", "2"],
    "qwen3-moe-adamw-masked": ["--arch", "qwen3-moe-30b-a3b", "--steps", "3",
                               "--seq-len", "32", "--lr", "3e-3",
                               "--batch-per-client", "2",
                               "--participation-rate", "0.5", "--seed", "1"],
}
_JAX_INIT = jax_alg.get_algorithm("mtsl").init_state


def _reference_init(arch, seed, hp):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    return jax.jit(lambda rng: _JAX_INIT(model, rng, cfg.num_clients, hp))(
        jax.random.PRNGKey(seed))


@pytest.mark.parametrize("name", list(ARGVS))
def test_port_moe_launcher_matches_reference(name, monkeypatch):
    argv = ARGVS[name]
    arch = argv[argv.index("--arch") + 1]
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0

    def jax_init(model, rng, num_clients, hp):
        return _reference_init(arch, seed, hp)

    def port_init(model, gen, num_clients, hp):
        state_j = _reference_init(arch, seed, jax_alg.HParams())
        p = params_from_jax(jax.tree.map(np.asarray, state_j.params), "cpu",
                            get_config(arch, smoke=True))
        p = tree_map(lambda x: x.requires_grad_(), p)
        return TrainState(p, alg_mod._mtsl_optimizer(hp).init(p), 0)

    monkeypatch.setitem(jax_alg._REGISTRY, "mtsl", dataclasses.replace(
        jax_alg.get_algorithm("mtsl"), init_state=jax_init))
    monkeypatch.setitem(alg_mod._REGISTRY, "mtsl", dataclasses.replace(
        alg_mod.get_algorithm("mtsl"), init_state=port_init))
    _, hist_j = jax_main(argv + ["--prefetch", "0"])
    _, hist = main(argv + ["--device", "cpu"])
    assert len(hist) == len(hist_j) >= 2
    for a, b in zip(hist, hist_j):
        for k in ("step", "round", "participants"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_launcher_refuses_archs_whose_batches_the_source_cannot_draw(arch):
    with pytest.raises(SystemExit, match="registry's round"):
        main(["--arch", arch, "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama-3.2-vision-11b",
                                  "whisper-tiny"])
def test_serving_launcher_refuses_the_unported_families(arch):
    from repro_torch.launch.serve import main as serve_main

    argv = ["--arch", arch, "--device", "cpu", "--smoke", "--prompt-len", "4",
            "--new-tokens", "2"]
    cfg = get_config(arch, smoke=True)
    assert serve_main(argv).shape == (cfg.num_clients, 2, 2)
    if cfg.family in ("vlm", "encdec"):
        with pytest.raises(SystemExit, match="does not support chunked prefill"):
            serve_main(argv + ["--engine", "continuous"])

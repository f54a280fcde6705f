"""`repro_torch.launch.serve --checkpoint` against the reference launcher
on the same file.

The file is written by the reference (`repro.train.checkpoint`), in the LM
example's {"params", "step"} format, for smoke mamba2-130m (the reference
launcher serves the smoke configs only). The reference launcher's greedy
tokens over it are the reference; the port's launcher loads the same file
(`load_serve_params`) and serves the reference launcher's prompts (its
`jax.random.randint` draw) through `ServeEngine.generate`: the tokens are
equal. The same weights as an Algorithm-registry state (mtsl, written by
the reference) serve the same tokens through the port's `main`, and
through `main` on the {"params"} file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.mtsl import TrainState as JaxTrainState
from repro.launch import serve as jax_serve
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import params_to_reference

ARCH, PROMPT_LEN, NEW, B = "mamba2-130m", 12, 6, 2


def _files(tmp_path):
    """The two files the reference writes for one set of weights (drawn by
    the port, carried to the reference's layout)."""
    cfg = get_config(ARCH, smoke=True)
    params = serve.init_params(build_model(cfg), cfg.num_clients, 3, "cpu")
    tree = jax.tree.map(jnp.asarray, params_to_reference(params, cfg))
    raw, reg = str(tmp_path / "lm.msgpack"), str(tmp_path / "mtsl.msgpack")
    jax_ckpt.save_checkpoint(raw, {"params": tree, "step": 5})
    jax_ckpt.save_algorithm_state(
        reg, "mtsl", JaxTrainState(tree, (), jnp.asarray(5, jnp.int32)),
        extra={"step": 5, "round": 5})
    return cfg, raw, reg


def _reference_prompts(cfg, seed=0):
    """The reference launcher's prompts (launch/serve.py main)."""
    rng = jax.random.PRNGKey(seed)
    return np.asarray(jax.random.randint(jax.random.fold_in(rng, 10),
                                         (cfg.num_clients, B, PROMPT_LEN), 0,
                                         cfg.vocab_size))


def test_checkpoint_serves_the_reference_launchers_tokens(tmp_path, monkeypatch):
    cfg, raw, reg = _files(tmp_path)
    flags = ["--arch", ARCH, "--prompt-len", str(PROMPT_LEN),
             "--new-tokens", str(NEW), "--batch-per-client", str(B)]
    want = np.asarray(jax_serve.main(flags + ["--checkpoint", raw]))

    model = build_model(cfg)
    for path in (raw, reg):
        params = serve.load_serve_params(path, model, "cpu")
        eng = ServeEngine(model, params, cfg.num_clients, PROMPT_LEN + NEW,
                          device="cpu")
        got = eng.generate({"tokens": _reference_prompts(cfg)}, NEW)
        np.testing.assert_array_equal(got.numpy(), want)

    # the port's main on both files: the same greedy tokens for its prompts
    outs = [serve.main(flags + ["--device", "cpu", "--checkpoint", p])
            for p in (raw, reg)]
    assert outs[0].shape == (cfg.num_clients, B, NEW)
    assert torch.equal(outs[0], outs[1])

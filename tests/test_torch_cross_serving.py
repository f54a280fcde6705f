"""The port's serving of the VLM (llama-3.2-vision-11b) and the
encoder-decoder (whisper-tiny) against the JAX reference, in f32 on the
smoke configs (the prefill + decode == forward twin of both lives in
tests/test_torch_decode_consistency.py):

  * `attn_decode(kv_src=...)`, one query's cross attention to a source
    (no rope, no cache; the port's goes through the flash-decode wrapper
    with kv_valid = Sk), within 2e-5 of the reference's, at the VLM's
    GQA and the encoder-decoder's MHA heads;
  * the `cross` block's prefill and decode (output and self-attention
    cache) within 1e-5 of the reference's block;
  * `generate_sequential` on a batch of M = 2 clients x 2 rows with the
    VLM's vision features or the audio frames: greedy tokens equal the
    reference's generate_sequential token for token over the same weights
    (drawn by the port, carried across with `params_to_reference`), and
    the prefill logits agree within 1e-4; the VLM's projected features
    ride in the caches' `extras`, the encoder-decoder's encoder output in
    its server cache;
  * the continuous engine refuses both families with the reference's
    message, and `ServeEngine.generate` serves them sequentially;
  * the launcher serves both with `--smoke` (generation and `--bench`),
    and the example twin (examples/torch_serve_mtsl.py) runs them;
  * `launch.serve --checkpoint` serves a {"params"} file that the
    reference wrote, loading every leaf bit-equal to the weights saved.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import stacks as JST
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import checkpoint as jax_ckpt
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import stacks as TST
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import convert_tree, params_to_reference
from repro_torch.utils.tree import tree_leaves_with_path

ARCHS = ["llama-3.2-vision-11b", "whisper-tiny"]
PROMPT, NEW, B = 7, 5, 2
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _src_len(cfg):
    return cfg.vis_seq if cfg.family == "vlm" else cfg.encoder_seq


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode_cross_matches_reference(arch):
    cfg_j, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    pj = strip(JL.attn_params(jax.random.PRNGKey(2), cfg_j, cross=True))
    pt = convert_tree(jax.tree.map(np.asarray, pj), "cpu", cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(3, _src_len(cfg), cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(functools.partial(JL.attn_decode, cfg=cfg_j))(
        pj, jnp.asarray(x), None, 0, kv_src=jnp.asarray(src))
    got = TL.attn_decode(pt, torch.tensor(x), None, None, cfg, kv_src=torch.tensor(src))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_block_serving_matches_reference(arch):
    cfg_j, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    bj, bt = JST.make_block(cfg_j, "cross"), TST.make_block(cfg, "cross")
    pj = strip(bj.init(jax.random.PRNGKey(6)))
    pt = convert_tree(jax.tree.map(np.asarray, pj), "cpu", cfg)
    rng = np.random.default_rng(1)
    L, cap = 9, 16
    x = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    x_t = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(B, _src_len(cfg), cfg.d_model)).astype(np.float32)

    @jax.jit
    def ref(p, x, x_t, src):
        y, cache = bj.prefill(p, x, {"max_len": cap, "xattn": src})
        y_t, cache_t = bj.decode(p, x_t, cache, {"pos": L, "xattn": src})
        return y, cache, y_t, cache_t

    want = jax.tree.map(np.asarray, ref(pj, *map(jnp.asarray, (x, x_t, src))))
    with torch.no_grad():
        y, cache = bt.prefill(pt, torch.tensor(x),
                              {"max_len": cap, "xattn": torch.tensor(src)})
        _close(y, want[0], 1e-5)
        for k in ("k", "v"):
            _close(cache[k], want[1][k], 1e-5)
        y_t = bt.decode(pt, torch.tensor(x_t), cache,
                        {"pos": L, "xattn": torch.tensor(src)})
        _close(y_t, want[2], 1e-5)
        for k in ("k", "v"):
            _close(cache[k], want[3][k], 1e-5)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The port's model, weights and seeded request batch, and the
    reference's greedy tokens and prefill logits over them."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    M = cfg.num_clients
    params = serve.init_params(model, M, 4, "cpu")
    inputs = serve.seeded_inputs(cfg, M, B, PROMPT, 11)
    cfg_j = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(jnp.asarray, params_to_reference(params, cfg))
    eng = JaxServeEngine(jax_build_model(cfg_j), tree, M, PROMPT + NEW)
    inputs_j = jax.tree.map(jnp.asarray, inputs)
    want = np.asarray(eng.generate_sequential(inputs_j, NEW))
    logits, _ = eng._prefill(eng.params, inputs_j)
    return cfg, model, params, inputs, want, np.asarray(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_sequential_matches_reference(arch):
    cfg, model, params, inputs, want, want_logits = _setup(arch)
    M = cfg.num_clients
    eng = ServeEngine(model, params, M, PROMPT + NEW, device="cpu")
    got = eng.generate_sequential(inputs, NEW)
    assert got.dtype == torch.int32 and got.shape == (M, B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        logits, caches = eng._prefill(params, {k: torch.as_tensor(v) for k, v in
                                               inputs.items()})
    _close(logits, want_logits, 1e-4)
    if cfg.family == "vlm":
        assert caches.extras["vis_proj"].shape == (M * B, cfg.vis_seq, cfg.d_model)
    else:
        assert caches.extras == {} and caches.tower == [{}] * M
        assert caches.server["enc_out"].shape == (M * B, cfg.encoder_seq, cfg.d_model)
    # generate() routes these families to the sequential engine
    assert torch.equal(eng.generate(inputs, NEW), got) and eng._cont == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses(arch):
    cfg, model, params, *_ = _setup(arch)
    assert model.tower_extend is None and model.server_extend is None
    with pytest.raises(ValueError, match="does not support chunked prefill"):
        ContinuousEngine(model, params, cfg.num_clients, 16, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_and_example_serve(arch):
    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    argv = ["--arch", arch, "--device", "cpu", "--smoke", "--prompt-len", "6",
            "--new-tokens", "3"]
    out = serve.main(argv)
    assert out.shape == (M, 2, 3) and int(out.min()) >= 0
    assert int(out.max()) < cfg.vocab_size
    m = serve.main(argv + ["--bench"])
    assert m["engine"] == "sequential" and len(m["outputs"]) == 2 * M
    with pytest.raises(SystemExit, match="does not support chunked prefill"):
        serve.main(argv + ["--engine", "continuous"])

    spec = importlib.util.spec_from_file_location(
        "torch_serve_mtsl", ROOT / "examples" / "torch_serve_mtsl.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--arch", arch, "--device", "cpu", "--prompt-len", "5",
                        "--new-tokens", "3"])
    assert out.shape == (M, 2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_a_reference_checkpoint(arch, tmp_path):
    cfg, model, params, *_ = _setup(arch)
    path = str(tmp_path / "lm.msgpack")
    jax_ckpt.save_checkpoint(path, {"params": jax.tree.map(
        jnp.asarray, params_to_reference(params, cfg)), "step": 5})
    loaded = dict(tree_leaves_with_path(serve.load_serve_params(path, model, "cpu")))
    want = dict(tree_leaves_with_path(params))
    assert sorted(loaded) == sorted(want)
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    out = serve.main(["--arch", arch, "--device", "cpu", "--checkpoint", path,
                      "--prompt-len", "5", "--new-tokens", "3"])
    assert out.shape == (cfg.num_clients, 2, 3)

"""The port's twin of tests/test_decode_consistency.py::
test_prefill_decode_matches_forward, for every assigned arch: on its smoke
config (f32), the serving hooks' prefill and step-by-step decode give the
teacher-forced forward's logits within 3e-5. The weights are the port's
seeded serving tree (f32 smoke configs: the training tree's values), the
inputs come from numpy; the VLM's vision features and the
encoder-decoder's frames ride along as the reference's test passes them.
"""
import numpy as np
import pytest
import torch

from conftest import ASSIGNED_ARCHS
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.launch.serve import init_params
from repro_torch.models import build_model


def _inputs(cfg, B, L, seed=3):
    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, L)))}
    if cfg.family == "vlm":
        inputs["vis"] = torch.as_tensor(
            rng.standard_normal((B, cfg.vis_seq, cfg.vis_dim), dtype=np.float32))
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    return inputs


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_decode_matches_forward(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = init_params(model, 1, 1, "cpu")
    tp, sp = client_view(params["towers"], 0), params["server"]
    B, S, T = 2, 8, 4
    inputs = _inputs(cfg, B, S + T)
    toks = inputs["tokens"]
    with torch.no_grad():
        full, _ = model.server_forward(sp, model.tower_forward(tp, inputs))
        sm, tcache = model.tower_prefill(tp, dict(inputs, tokens=toks[:, :S]), S + T)
        logits, scache = model.server_prefill(sp, sm, S + T)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - 1].numpy(),
                                   atol=3e-5, rtol=0)
        for t in range(T):
            pos = S + t
            inp_t = {"tokens": toks[:, pos:pos + 1]}
            if cfg.family == "vlm":
                inp_t["vis_proj"] = sm["vis_proj"]
            sm_t = model.tower_decode(tp, inp_t, tcache, pos)
            logits = model.server_decode(sp, sm_t, scache, pos)
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, pos].numpy(),
                                       atol=3e-5, rtol=0)

"""The port's configs and their billing against the JAX reference's.

  * Every config the reference registers (full and smoke) is registered in
    the port, field for field equal, with the same layer kinds.
  * `model_param_counts` of the archs added with the MoE, VLM and
    encoder-decoder families and the remaining dense configs: the port
    counts its own inits on the meta device, the reference is counted
    through `jax.eval_shape` (its own call would allocate every parameter
    of the full config). Equal, as integers.
  * mtsl's `round_bytes` on star(M) at those counts, equal to the
    reference's, the encoder-decoder's smashed term `encoder_seq · d_model`
    per sample included.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs.base import _SMOKE as JAX_SMOKE
from repro.core import algorithms as jax_alg
from repro.models.registry import build_model as jax_build_model
from repro.utils.sharding import strip
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import _SMOKE
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import comm_cost
from repro_torch.models.registry import build_model

NEW_ARCHS = ("deepseek-7b", "mistral-nemo-12b", "mistral-large-123b",
             "deepseek-moe-16b", "qwen3-moe-30b-a3b", "llama-3.2-vision-11b",
             "whisper-tiny")


def test_every_reference_config_is_registered():
    assert list_configs() == jax_list_configs()
    assert sorted(_SMOKE) == sorted(JAX_SMOKE)


@pytest.mark.parametrize("name,smoke", [(n, False) for n in jax_list_configs()]
                         + [(n, True) for n in sorted(JAX_SMOKE)])
def test_config_fields_equal_the_reference(name, smoke):
    cfg, cfg_j = get_config(name, smoke=smoke), jax_get_config(name, smoke=smoke)
    assert cfg.__dict__ == cfg_j.__dict__
    assert cfg.layer_kinds == cfg_j.layer_kinds
    assert cfg.param_count() == cfg_j.param_count()


def _reference_counts(arch):
    model = jax_build_model(jax_get_config(arch))
    key = jax.random.PRNGKey(0)

    def n(fn):
        return sum(int(np.prod(x.shape)) for x in
                   jax.tree.leaves(jax.eval_shape(lambda k: strip(fn(k)), key)))

    tower = n(model.init_tower)
    return tower, tower + n(model.init_server)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_counts_and_round_bytes_match_reference(arch):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    tower, total = comm_cost.model_param_counts(build_model(cfg))
    assert (tower, total) == _reference_counts(arch)
    M, b = 4, 8
    hp, hp_j = alg_mod.HParams(), jax_alg.HParams()
    for name in ("mtsl", "splitfed", "fedavg"):
        got = alg_mod.get_algorithm(name).round_bytes(
            cfg, M, b, hp, tower_params=tower, total_params=total)
        want = jax_alg.get_algorithm(name).round_bytes(
            cfg_j, M, b, hp_j, tower_params=tower, total_params=total)
        assert got == want, name
    if cfg.family == "encdec":  # smashed frames up, their gradients down
        smashed = b * cfg.encoder_seq * cfg.d_model
        assert comm_cost._smashed_elems(cfg, b, seq_len=448) == smashed

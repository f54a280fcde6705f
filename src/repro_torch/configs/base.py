"""Config system: the port's own copy of `repro.configs.base` (ModelConfig,
INPUT_SHAPES and the registry), kept field-for-field identical so a config
built in one package means the same model in the other.

`use_flash_kernel` is kept for parity with the reference, but the port
does not read it: decode attention always goes through the flash-decode
wrapper (K4), the training forward's causal attention through the
flash-attention wrapper (K2) and the Mamba2 scan through the SSD-scan
wrapper (K3). Each launches its CUDA kernel on CUDA tensors and runs its
plain version on CPU tensors. (The reference's flag selects between its
Pallas kernels and their oracles; the two agree.)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Input shapes (fixed by the assignment)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | mlp | resnet
    source: str = ""  # citation / model card

    # transformer backbone -----------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    max_seq: int = 131_072

    # attention pattern: cycled over layers. entries: "full" | "swa"
    # ("mamba", "shared_attn" used by ssm/hybrid; "cross" injected by vlm)
    attn_pattern: tuple = ("full",)
    sliding_window: int = 0  # window size for "swa" layers

    # moe ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading dense layers before MoE layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1  # dispatch groups (set = data shards for local sort)

    # ssm (mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): every Nth layer also applies the *shared* attn block
    shared_attn_every: int = 0

    # encoder-decoder (whisper) ----------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend frames (1500 for whisper)

    # vlm ----------------------------------------------------------------
    cross_attn_every: int = 0  # every Nth layer is a cross-attn layer
    vis_seq: int = 0
    vis_dim: int = 0

    # mlp / resnet (paper-scale models) ---------------------------------------
    mlp_dims: tuple = ()
    image_size: int = 28
    image_channels: int = 1
    num_classes: int = 10
    resnet_stages: tuple = ()  # e.g. ((16,2),(32,2),(64,2)) blocks per stage

    # MTSL split -----------------------------------------------------------
    split_layers: int = 2  # bottom blocks (+ embedding) in the client tower
    num_clients: int = 16  # M; on the mesh, mapped to pod*data shards

    # numerics / performance knobs (hillclimb surface) -----------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"  # none | block | full
    scan_layers: bool = True
    fsdp: bool = False  # shard server params over the data axis too
    seq_shard: bool = False  # shard long activations over model axis
    microbatches: int = 1  # grad-accumulation steps inside train_step
    # reference: Pallas kernels on/off. Port: not read (see the module
    # docstring)
    use_flash_kernel: bool = False
    attn_impl: str = "ref"  # "ref" (full scores) | "chunked" (online softmax)
    attn_chunk: int = 1024  # KV chunk for attn_impl="chunked"
    decode_long_window: int = 0  # >0: SWA ring-buffer KV for long decode

    # ----------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer block kinds, expanding attn_pattern / family rules."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("mamba")
            elif self.family == "hybrid":
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    kinds.append("shared_attn")
                else:
                    kinds.append("mamba")
            elif self.family == "vlm" and self.cross_attn_every and (
                (i + 1) % self.cross_attn_every == 0
            ):
                kinds.append("cross")
            elif self.family == "moe" and i < self.first_dense_layers:
                kinds.append("dense_moe_lead")
            elif self.family == "moe":
                kinds.append("moe")
            else:
                kinds.append(self.attn_pattern[i % len(self.attn_pattern)])
        return tuple(kinds)

    def with_updates(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # --- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.head_dim
        attn = d * self.num_heads * h + 2 * d * self.num_kv_heads * h + self.num_heads * h * d
        dense_ffn = 3 * d * self.d_ff
        n = 0
        embed = self.vocab_size * d
        n += embed if self.tie_embeddings else 2 * embed
        mamba = 0
        if self.ssm_state:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_headdim
            # in_proj (z,x,B,C,dt) + conv + out_proj
            mamba = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d + \
                self.ssm_conv_width * (d_in + 2 * self.ssm_state)
        for kind in self.layer_kinds:
            if kind in ("full", "swa"):
                n += attn + dense_ffn
            elif kind == "cross":
                n += 2 * attn + dense_ffn  # self + cross attention
            elif kind == "mamba":
                n += mamba
            elif kind == "shared_attn":
                n += mamba  # shared attn params counted once below
            elif kind == "dense_moe_lead":
                n += attn + 3 * d * (self.moe_d_ff * (self.num_experts // 4) if not self.d_ff else self.d_ff)
            elif kind == "moe":
                experts = self.num_experts if not active_only else self.experts_per_token
                n += attn + 3 * d * self.moe_d_ff * (experts + self.num_shared_experts)
                n += d * self.num_experts  # router
        if self.shared_attn_every:
            n += attn + dense_ffn  # the single shared attention block
        if self.family == "vlm":
            n += self.vis_dim * d  # projector
        if self.family == "encdec":
            n += self.encoder_layers * (attn + dense_ffn)
        return int(n)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: Optional[ModelConfig] = None) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    if smoke is not None:
        _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown config {name!r}; have {sorted(table)}")
    return table[name]


def list_configs(assigned_only: bool = False) -> list[str]:
    names = sorted(_REGISTRY)
    if assigned_only:
        names = [n for n in names if not n.startswith("paper-")]
    return names

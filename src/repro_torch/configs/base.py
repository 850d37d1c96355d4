"""Config system for the AutoDFL reproduction framework.

Every assigned architecture is expressed as a :class:`ModelConfig`; every
assigned input shape as a :class:`ShapeConfig`.  The cross product (minus the
documented skips) defines the dry-run / roofline cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used by hybrid / mixed stacks.
# ---------------------------------------------------------------------------
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (None on dense archs)."""

    n_experts: int
    top_k: int
    expert_d_ff: int
    # Apply MoE FFN every `period` layers (Jamba uses 2: alternating MoE/dense).
    period: int = 1
    # Capacity factor for the dispatch (dropping) path.
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How this architecture is laid out on the (pod, data, model) mesh."""

    fsdp: bool = True           # shard params / opt state over the data axis
    tensor_parallel: bool = True  # shard matmul dims over the model axis
    sequence_parallel: bool = False  # shard the residual stream's seq dim
    expert_parallel: bool = True  # shard MoE experts over the model axis
    remat: str = "full"         # none | dots | full
    # Decode-time KV-cache sharding: shard cache seq dim over model axis when
    # kv heads < model axis (GQA small-kv archs, long-context decode).
    kv_seq_shard: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm | conv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_variant: str = "rope"    # rope | mrope | none
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    # Repeating block pattern; None => all ATTN.  The full stack is
    # n_layers // len(pattern) repetitions of the pattern (scan over periods).
    block_pattern: Optional[Tuple[str, ...]] = None

    # Encoder-decoder (whisper): encoder layer count and fixed frame count.
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0

    # Modality frontend stub: tokens | embeds (vlm) | audio (enc-dec frames)
    input_mode: str = "tokens"

    # Mamba block hyperparameters (hybrid family).
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4

    # xLSTM projection factors.
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333333333333333

    optimizer: str = "adamw"      # adamw | adafactor | sgdm
    dtype: str = "bfloat16"
    sharding: ShardingPolicy = dataclasses.field(default_factory=ShardingPolicy)

    # Sub-quadratic story: archs whose every token-mixing layer is full
    # attention cannot run the 500k-context cell.
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block_pattern is not None:
            assert self.n_layers % len(self.block_pattern) == 0, (
                self.name, self.n_layers, self.block_pattern)

    # -- derived ------------------------------------------------------------
    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or (ATTN,)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # input embedding
        total += v * d  # lm head (untied)
        counts = {
            ATTN: self._attn_params() + self._ffn_params_dense(),
            MAMBA: self._mamba_params() + 0,
            MLSTM: self._mlstm_params(),
            SLSTM: self._slstm_params(),
        }
        n_rep = self.n_periods
        for i, kind in enumerate(self.pattern):
            c = counts[kind]
            if kind in (ATTN, MAMBA) and self.moe is not None:
                # layers alternate MoE / dense FFN with the MoE period
                per = self.moe.period
                if per == 1 or (i % per) == (per - 1):
                    c = (self._attn_params() if kind == ATTN else self._mamba_params())
                    c += self._ffn_params_moe()
            total += c * n_rep
        if self.enc_dec:
            # encoder blocks (self-attn + ffn) + decoder cross-attn
            enc = (self._attn_params() + self._ffn_params_dense()) * self.n_enc_layers
            cross = self._attn_params() * self.n_layers
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_layers = self._n_moe_layers()
        per_expert = 3 * self.d_model * self.moe.expert_d_ff
        inactive = moe_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return full - inactive

    def _n_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        n = 0
        for i, kind in enumerate(self.pattern):
            if kind in (ATTN, MAMBA):
                per = self.moe.period
                if per == 1 or (i % per) == (per - 1):
                    n += 1
        return n * self.n_periods

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _ffn_params_dense(self) -> int:
        if self.d_ff == 0:
            return 0
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def _ffn_params_moe(self) -> int:
        m = self.moe
        router = self.d_model * m.n_experts
        return router + m.n_experts * 3 * self.d_model * m.expert_d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        di = d * self.mamba_expand
        ds = self.mamba_d_state
        # in_proj (x and z), conv, ssm params (dt, B, C proj), out_proj
        return (d * 2 * di + di * self.mamba_d_conv
                + di * (ds * 2 + di // 16 + 1) + di * d)

    def _mlstm_params(self) -> int:
        d = self.d_model
        di = int(d * self.mlstm_proj_factor)
        # up (x,z), qkv from di, gates, out
        return d * 2 * di + 3 * di * di + 2 * di + di * d

    def _slstm_params(self) -> int:
        d = self.d_model
        df = int(d * self.slstm_proj_factor)
        # 4 gates (recurrent + input) + ffn up/down
        return 8 * d * d + 2 * d * df


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes -------------------------------------------------
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_is_skipped(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip-reason string, or None if the (arch, shape) cell runs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 500k-context decode requires "
                "sub-quadratic token mixing (see DESIGN.md shape/skip matrix)")
    if cfg.family == "conv":
        if shape.name != "train_4k":
            return "paper's own LeNet-5 config: FL training example only"
    return None


def live_cells(configs, shapes=None):
    shapes = shapes or [SHAPES[s] for s in SHAPE_ORDER]
    out = []
    for cfg in configs:
        for shape in shapes:
            if cell_is_skipped(cfg, shape) is None:
                out.append((cfg, shape))
    return out

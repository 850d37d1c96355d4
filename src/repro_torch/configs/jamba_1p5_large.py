"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Stack = 9 repetitions of an 8-layer period (attention at index 4, Mamba
elsewhere); MoE FFN every 2nd layer (Jamba recipe).  Hybrid recurrence =>
sub-quadratic => long_500k runs (the sparse attention layers hold an
SP-sharded 500k KV cache).
"""
from repro_torch.configs.base import ATTN, MAMBA, MoEConfig, ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=24576, period=2),
    block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    optimizer="adafactor",
    subquadratic=True,
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True,
                            expert_parallel=True, sequence_parallel=True,
                            remat="full", kv_seq_shard=True),
)

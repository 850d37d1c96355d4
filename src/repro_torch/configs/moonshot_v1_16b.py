"""moonshot-v1-16b-a3b — kimi/moonlight 64-expert top-6 MoE
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408),
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True,
                            expert_parallel=True, sequence_parallel=True, remat="full",
                            kv_seq_shard=True),
)

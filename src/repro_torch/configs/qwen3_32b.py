"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True,
                            sequence_parallel=True, remat="dots",
                            kv_seq_shard=True),
)

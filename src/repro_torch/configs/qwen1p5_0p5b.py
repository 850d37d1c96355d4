"""qwen1.5-0.5b — QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16 == MHA) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True, remat="full",
                            kv_seq_shard=True),
)

"""qwen2-0.5b — GQA, QKV bias [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True, remat="full",
                            kv_seq_shard=True),
)

"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  Backbone only: the
vision frontend is a STUB — input_specs() provides precomputed patch/token
embeddings plus 3-section M-RoPE position ids (temporal, height, width).
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_variant="mrope",
    rope_theta=1_000_000.0,
    input_mode="embeds",
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True,
                            sequence_parallel=True, remat="full",
                            kv_seq_shard=True),
)

"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L d_model=1024 16H d_ff=4096 vocab=51865.  24 encoder + 24 decoder layers;
the audio conv frontend is a STUB: input_specs() provides precomputed frame
embeddings of shape (batch, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    rope_variant="none",   # whisper uses learned absolute positions
    enc_dec=True,
    n_enc_layers=24,
    enc_seq=1500,
    input_mode="audio",
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True, remat="dots",
                            kv_seq_shard=True),
)

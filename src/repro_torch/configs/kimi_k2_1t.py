"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384e top-8.  ~1.03T total params, ~32B active.  Training states use
adafactor (factored second moment) — see DESIGN.md memory notes; the
single-pod train_4k cell exceeds v5e HBM by construction and is reported
honestly in EXPERIMENTS.md (fits on the 2-pod mesh).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, expert_d_ff=2048),
    optimizer="adafactor",
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True,
                            expert_parallel=True, sequence_parallel=True,
                            remat="full", kv_seq_shard=True),
)

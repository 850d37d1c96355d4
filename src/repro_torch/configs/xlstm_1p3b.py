"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: the xLSTM blocks
carry their own pre-up/post-down projections.  Block ratio mLSTM:sLSTM = 7:1
(the xLSTM[7:1] recipe), expressed as a repeating 8-block period so the stack
scans over 6 periods.  Recurrent state => sub-quadratic => long_500k runs.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_variant="none",
    norm="layernorm",
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    subquadratic=True,
    sharding=ShardingPolicy(fsdp=True, tensor_parallel=True, remat="dots"),
)

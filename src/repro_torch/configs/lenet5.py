"""lenet5 — the paper's own FL workload (LeNet-5 on MNIST, §VI-B).

Used by the paper-faithful federated-learning example (examples/fl_mnist.py)
and the reputation-dynamics benchmark (Fig. 3).  Not part of the LM dry-run
grid; exercised end-to-end on CPU.
"""
from repro_torch.configs.base import ModelConfig, ShardingPolicy

CONFIG = ModelConfig(
    name="lenet5",
    family="conv",
    n_layers=5,
    d_model=84,        # final FC width (kept for interface uniformity)
    n_heads=1,
    n_kv_heads=1,
    d_ff=120,
    vocab_size=10,     # 10 classes
    rope_variant="none",
    norm="layernorm",
    input_mode="image",
    sharding=ShardingPolicy(fsdp=False, tensor_parallel=False, remat="none"),
)

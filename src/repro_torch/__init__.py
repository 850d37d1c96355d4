"""PyTorch/CUDA port of the AutoDFL ledger (the JAX package ``src/repro``
is its reference).  Entry points run on the first CUDA card unless the
caller passes ``device=``; see ``repro_torch.api``."""

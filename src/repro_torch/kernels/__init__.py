"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the factory that routes the ledger's ops to them."""

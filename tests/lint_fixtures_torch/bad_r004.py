"""R004 fixture (port form): host syncs and value branching inside
functions that torch.func transforms or torch.compile traces."""
import torch
from torch.func import grad, vmap


def step(x, w):
    if x.sum() > 0:                  # Python branch on a batched value
        x = x * w
    total = float(w)                 # pulls a traced value to the host
    torch.cuda.synchronize()         # waits for the device every call
    return x * total


batched = vmap(step)


def loss(p):
    return (p * p).sum().item()      # host sync under grad


dloss = grad(loss)


@torch.compile
def fused(x):
    return x.cpu()                   # host copy inside the compiled graph

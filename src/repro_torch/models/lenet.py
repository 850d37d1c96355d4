"""LeNet-5 — the paper's own FL workload (MNIST, §VI-B): the port of
``src/repro/models/lenet.py``.

Two 5x5 tanh convolutions, each followed by a 2x2 average pool, and three
dense layers (tanh, tanh, logits).  The model works on image batches
``{"images": (B, 32, 32, 1) float32, "labels": (B,) int}`` and keeps the
JAX package's layouts: images NHWC, convolution weights HWIO, dense
weights (in, out), the pooled map flattened in (H, W, C) order; ``forward``
permutes to PyTorch's NCHW / OIHW around ``F.conv2d``.

It has the interface of ``models.mlp.TinyMLP``, which ``AutoDFL``,
``TrainingAgent``, ``VectorCohort`` and the DON take: parameters are a
flat dict of tensors whose keys (``conv1.b``, ``conv1.w``, ``conv2.b``, ..,
``fc3.w``) sort in the order the JAX package's nested tree flattens its
leaves, so a draw per sorted key lands on the same leaf in both packages;
``loss`` and the accuracy run the module through
``torch.func.functional_call``, so a cohort's stacked per-trainer
parameters vmap.  ``params_from_numpy`` / ``params_to_numpy`` carry the
JAX package's nested parameters across as numpy arrays.

``LeNet(cfg, device, mesh=mesh)`` takes a ``DeviceMesh`` (``launch/
mesh.py``) and carries it in ``self.ctx`` (``sharding.specs.MeshCtx``), as
``models.model.Model`` does: ``init_params`` then lays the host draw out
as DTensors by ``params_pspecs`` (the specs' fallback, the JAX package's:
the 2-D dense weights over (fsdp, tp), which lenet5's policy turns off,
so every weight lies whole on every rank) and the steps take DTensor
batches laid out by ``input_pspecs`` (images and labels over the DP
axes).  The convolutions and pools run in a ``MeshCtx.local`` region on
each rank's rows; the dense layers, the loss and the accuracy run on the
DTensors as they are.  With no mesh the region calls its function and
the same ops run on whole tensors.

The convolutions, pools and dense layers are library calls: the JAX
package computes them in ``lax.conv_general_dilated`` and jnp, outside any
Pallas kernel.  cuDNN runs a float32 convolution in TF32 unless told
otherwise (``torch.backends.cudnn.allow_tf32`` is True by default), so
``forward`` scopes ``fp32_convolutions`` around them: the model's numbers
are float32 on the card as on the CPU, and no global flag changes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import truncated_normal_init
from repro_torch.sharding.specs import MeshCtx, P, params_pspec_tree

Params = Dict[str, torch.Tensor]

# (weight shape, bias width) of each layer, in the JAX package's layouts
LAYERS: Dict[str, Tuple[Tuple[int, ...], int]] = {
    "conv1": ((5, 5, 1, 6), 6),
    "conv2": ((5, 5, 6, 16), 16),
    "fc1": ((400, 120), 120),
    "fc2": ((120, 84), 84),
    "fc3": ((84, 10), 10),
}


def fp32_convolutions():
    """A context in which cuDNN convolutions run in full float32 (TF32
    off), every other cuDNN setting as it was; the previous settings come
    back on exit."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def params_from_numpy(tree: Dict[str, Dict[str, np.ndarray]],
                      device=None) -> Params:
    """The JAX package's nested LeNet parameters ({"conv1": {"w", "b"},
    ..}, host arrays) as the flat dict of tensors on ``device`` (the card
    unless named)."""
    dev = resolve_device(device)
    return {f"{layer}.{leaf}": torch.from_numpy(np.array(tree[layer][leaf],
                                                         np.float32)).to(dev)
            for layer in sorted(tree) for leaf in sorted(tree[layer])}


def params_to_numpy(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The flat dict as the JAX package's nested tree of host arrays."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key in sorted(params):
        layer, leaf = key.split(".")
        out.setdefault(layer, {})[leaf] = params[key].detach().cpu().numpy()
    return out


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2 (the JAX package's window sum / 4)."""
    return F.avg_pool2d(x, 2)


def _features(images, c1w, c1b, c2w, c2b):
    """The convolutions and pools: images (B, 32, 32, 1) NHWC -> the
    pooled map flattened in (H, W, C) order, (B, 400)."""
    x = images.permute(0, 3, 1, 2)
    with fp32_convolutions():
        for w, b in ((c1w, c1b), (c2w, c2b)):
            y = F.conv2d(x, w.permute(3, 2, 0, 1))
            x = _pool(torch.tanh(y + b[:, None, None]))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LeNet(nn.Module):
    """LeNet-5 on ``device`` (the card unless named; under a ``mesh``, the
    mesh's device)."""

    def __init__(self, cfg=None, device=None, *, mesh=None):
        super().__init__()
        if cfg is None:
            from repro_torch.configs.registry import get_config
            cfg = get_config("lenet5")
        self.cfg = cfg
        if mesh is not None and device is None:
            from repro_torch.launch.mesh import mesh_device
            device = mesh_device(mesh)
        self.ctx = MeshCtx(mesh, cfg.sharding)
        dev = resolve_device(device)
        for name, (w_shape, width) in LAYERS.items():
            layer = nn.Module()
            layer.w = nn.Parameter(torch.zeros(w_shape, device=dev))
            layer.b = nn.Parameter(torch.zeros(width, device=dev))
            self.add_module(name, layer)
        self.load_params(self._draw(0))

    @property
    def device(self) -> torch.device:
        return self.fc3.w.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 32, 32, 1) NHWC -> logits (B, 10)."""
        rows = self.ctx.fit(P(self.ctx.dp_axes or None), images.shape[:1])
        x = self.ctx.local(_features, (P(*rows, None, None, None),)
                           + (P(),) * 4, P(*rows, None))(
            images, self.conv1.w, self.conv1.b, self.conv2.w, self.conv2.b)
        x = torch.tanh(x @ self.fc1.w + self.fc1.b)
        x = torch.tanh(x @ self.fc2.w + self.fc2.b)
        return x @ self.fc3.w + self.fc3.b

    def _draw(self, seed: int) -> Params:
        """``init_params``' weights, whole, on the model's device."""
        g = torch.Generator().manual_seed(int(seed))
        host = {}
        for name, (w_shape, width) in LAYERS.items():
            host[f"{name}.b"] = torch.zeros(width)
            host[f"{name}.w"] = truncated_normal_init(
                w_shape, w_shape[-2] ** -0.5, torch.float32, g, "cpu")
        return {k: host[k].to(self.device) for k in sorted(host)}

    def init_params(self, seed: int) -> Params:
        """The JAX package's init: each weight a standard normal cut at
        +-2 times fan_in^-1/2 (fan_in its second-to-last axis, as
        ``dense_init`` takes it), zero biases.  Drawn on the host from a
        ``torch.Generator`` seeded with ``seed`` and moved to the model's
        device, so the card and the CPU start from the same values; under
        a mesh each laid out by ``params_pspecs`` (``launch.steps.
        shard``: each rank keeps its own shard)."""
        params = self._draw(seed)
        if self.ctx.mesh is None:
            return params
        from repro_torch.launch.steps import shard
        specs = self.params_pspecs()
        return {k: shard(self.ctx, v, specs[k], self.device)
                for k, v in params.items()}

    def params_shape(self) -> Params:
        """The weights as ``meta`` tensors, keyed as ``init_params``."""
        return {f"{name}.{leaf}": torch.empty(
            shape if leaf == "w" else (width,), device="meta")
            for name, (shape, width) in sorted(LAYERS.items())
            for leaf in ("b", "w")}

    def params_pspecs(self) -> dict:
        """Each weight's partition spec (``sharding.specs.
        params_pspec_tree``: the JAX specs' fallback)."""
        return params_pspec_tree(self.ctx, self.params_shape())

    def input_pspecs(self, shape: ShapeConfig) -> dict:
        """The partition specs of a batch of ``shape`` (the JAX facade's
        conv branch): images (B, 32, 32, 1) and labels (B,) over the DP
        axes."""
        dp = self.ctx.dp_axes or None
        return {"images": P(dp, None, None, None), "labels": P(dp)}

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        """Copies whole tensors into the module's own weights."""
        for key, value in params.items():
            self.get_parameter(key).copy_(value)

    def logits(self, p: Params, batch) -> torch.Tensor:
        return torch.func.functional_call(self, p, (batch["images"],))

    def loss(self, p: Params, batch, remat=None) -> torch.Tensor:
        """Mean cross entropy, in float32 (the JAX package's loss_fn,
        which takes and ignores ``remat`` too, so that
        ``launch.steps.build_train_step`` drives either model)."""
        lo = self.logits(p, batch).to(torch.float32)
        lse = torch.logsumexp(lo, dim=-1)
        ll = torch.gather(lo, -1, batch["labels"].to(torch.int64)[:, None]
                          )[..., 0]
        return torch.mean(lse - ll)

    def accuracy_fn(self):
        """eval_fn(params, batch) -> accuracy scalar (DON scoring), the
        mean as the float32 count of hits times ``1/B`` (``TinyMLP``'s
        rule: equal predictions give bit-equal scores to the JAX
        package's compiled mean)."""
        def accuracy(p: Params, batch) -> torch.Tensor:
            pred = torch.argmax(self.logits(p, batch), dim=-1)
            hits = (pred == batch["labels"].to(torch.int64)).to(
                torch.float32)
            return hits.sum() * (1.0 / hits.shape[-1])
        return accuracy

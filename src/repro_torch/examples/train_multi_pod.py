"""End-to-end driver, the port's twin of ``examples/train_multi_pod.py``:
rollup-FL training of an LM across the production mesh, through
``repro_torch.launch.train``.  Under ``torchrun`` on 256 (or, with
``--multi-pod``, 512) cards it runs the mesh round on the 16 x 16 (2 x 16
x 16) mesh; ``--host-mesh`` runs one card, ``--mesh-shape`` a smaller
mesh of CPU ranks.

Usage (on the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.examples.train_multi_pod \\
        --arch qwen2-0.5b --rounds 3 --local-steps 2 --host-mesh --reduced
"""
from __future__ import annotations

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()

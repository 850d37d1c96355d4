"""The port's twins of the JAX package's ``examples/``, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``): ``quickstart``, ``serve_demo``, ``serve_quickstart``
and ``train_multi_pod``.  ``examples/fl_mnist.py``'s twin is
``repro_torch.launch.fl_mnist``."""

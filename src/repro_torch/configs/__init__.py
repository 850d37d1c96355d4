"""Architecture and shape configs: the JAX package's ``configs`` copied as
data (the port imports nothing of that package).  ``registry`` maps
``--arch`` ids to :class:`~repro_torch.configs.base.ModelConfig`."""

"""Content-addressed checkpoints of trees of tensors."""

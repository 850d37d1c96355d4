"""Fault tolerance of the training launcher."""

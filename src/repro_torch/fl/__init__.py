"""The FL protocol of the port: cohorts, the protocol node, the scheduler."""

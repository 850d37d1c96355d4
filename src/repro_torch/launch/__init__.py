"""Entry points of the port that a user launches from the command line."""

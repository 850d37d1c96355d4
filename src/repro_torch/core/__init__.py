"""Ledger core of the port: state, engine, prover, events, gas."""

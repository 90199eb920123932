"""Structured max-oracles as OracleSpecs (this slice: the chain task)."""

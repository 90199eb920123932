"""Structured max-oracles as OracleSpecs (ported so far: the chain task)."""

"""Structured max-oracles as OracleSpecs: the multiclass, chain and graph
tasks of the paper's three scenarios."""

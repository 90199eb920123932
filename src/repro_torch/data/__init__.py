"""Synthetic datasets of the paper's scenarios."""

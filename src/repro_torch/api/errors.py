"""Typed errors for the public API layer."""
from __future__ import annotations


class UnsupportedConfigError(ValueError):
    """A RunConfig asks for an engine or capability the port lacks."""

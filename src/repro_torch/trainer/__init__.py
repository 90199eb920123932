"""Trainer modes built on the port's optimizer."""

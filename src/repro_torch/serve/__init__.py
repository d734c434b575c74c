"""Serving: the continuous-batching slot engine."""

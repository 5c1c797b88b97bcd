"""Continuous-batching slot runtime."""

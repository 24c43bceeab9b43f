"""Continuous-batching serving engine over the port's models."""

"""Gradient compression (int8 with error feedback)."""

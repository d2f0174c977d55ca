"""Utilities without a model dependency."""

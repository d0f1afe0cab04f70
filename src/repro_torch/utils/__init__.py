"""Compatibility shims (``metrics``)."""

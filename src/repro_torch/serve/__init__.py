"""Serving (this slice: shape-bucketed CNN classification and its metrics)."""

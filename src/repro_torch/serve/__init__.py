"""Serving: the continuous-batching LM engine, its scheduler and fault plan,
shape-bucketed CNN classification, the mixed loop, and their metrics."""

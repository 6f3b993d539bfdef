"""Data: the step-addressed synthetic streams and file-backed token shards."""

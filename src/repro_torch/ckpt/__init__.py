"""Checkpoints: sharded, atomic, CRC-checked, with newest-valid fallback."""

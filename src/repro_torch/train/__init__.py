"""Training: AdamW, the guarded train steps, the crash-safe loop and its fault plan."""

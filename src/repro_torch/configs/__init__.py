"""Model configurations (this slice: the AlexNet-style CNN)."""

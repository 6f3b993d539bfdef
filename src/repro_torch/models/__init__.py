"""Models (this slice: the AlexNet-style CNN)."""

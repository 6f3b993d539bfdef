"""Models: the dense transformer LM and the AlexNet-style CNN."""

"""The plain reference that decides `correct`: plain PyTorch, float32,
importing nothing of the port."""

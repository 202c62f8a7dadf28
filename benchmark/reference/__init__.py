"""The plain reference that decides `correct`: PyTorch in float32, importing nothing of the program."""

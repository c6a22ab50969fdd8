"""Tensor ops of the port: kernel wrappers with their plain versions, and
the plain PyTorch ops around them."""

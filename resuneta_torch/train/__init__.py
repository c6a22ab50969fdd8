"""Weights on disk (checkpoint.py); the training loop arrives with the
training slice."""

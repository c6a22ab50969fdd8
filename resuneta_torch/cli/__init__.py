"""Command-line entry points of the port (`python -m resuneta_torch.cli.<name>`)."""

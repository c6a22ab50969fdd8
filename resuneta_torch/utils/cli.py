"""CLI helpers shared by the port's entry points (resuneta_tpu/utils/cli.py;
str2bool matches train_ISPRS.py:19-27). The reference's `setup_platform`
has no counterpart: the port's CLIs take `--device`."""

import argparse


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def print_on_coordinator(group):
    """print on rank 0 of a data-parallel group (or without one); a no-op
    on the other ranks."""
    if group is None or group.rank == 0:
        return print
    return lambda *args, **kwargs: None

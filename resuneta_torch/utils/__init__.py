from .cli import str2bool
from .table import ascii_table

__all__ = ["ascii_table", "str2bool"]

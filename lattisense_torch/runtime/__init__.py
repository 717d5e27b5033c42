"""User-facing contexts."""

from .context import BfvContext

__all__ = ['BfvContext']

"""User-facing contexts and the compiled-task runtime."""

from .context import BfvContext
from .task import FheTask, FheTaskGpu

__all__ = ['BfvContext', 'FheTask', 'FheTaskGpu']

"""User-facing contexts and the compiled-task runtime."""

from .context import (BfvContext, CkksBtpContext, CkksContext, FheContext,
                      create_context_for_params)
from .task import FheTask, FheTaskGpu

__all__ = ['BfvContext', 'CkksBtpContext', 'CkksContext', 'FheContext', 'FheTask', 'FheTaskGpu',
           'create_context_for_params']

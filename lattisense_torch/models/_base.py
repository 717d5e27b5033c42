"""Shared model plumbing: build → compile → run.

Port of ``lattisense_tpu/models/_base.py``. A model compiles its graph with
the port's frontend (``frontend/custom_task.py``) and runs it with the
port's ``FheTask`` on the context's device.
"""

import tempfile


class FheModel:
    """Base: subclasses implement ``_build(ct)`` returning
    (input_args, output_args), plus input packing / output decoding."""

    algo = 'CKKS'

    def __init__(self, fe_param):
        self.fe_param = fe_param
        self.task_dir = None

    def required_rotations(self):
        return []

    def required_galois_elements(self):
        """Direct Galois-element keys (advanced rotations); subclasses
        using `advanced_rotate_cols` list them here."""
        return []

    def compile(self, task_dir: str | None = None):
        """Build the graph and serialize the task contract."""
        from ..frontend import custom_task as ct
        self.task_dir = task_dir or tempfile.mkdtemp(
            prefix=f'{type(self).__name__.lower()}_task_')
        ct.set_fhe_param(self.fe_param)
        ins, outs = self._build(ct)
        ct.process_custom_task(ins, outs,
                               output_instruction_path=self.task_dir)
        return self.task_dir

    def load(self, context, **task_kwargs):
        """Compile (if needed), generate rotation keys on ``context``, return
        an ``FheTask`` on the context's device (``FheTask.run`` refuses a
        context on another device)."""
        from ..runtime import FheTask
        if self.task_dir is None:
            self.compile()
        rots = self.required_rotations()
        if rots:
            context.gen_rotation_keys_for_rotations(rots)
        elts = self.required_galois_elements()
        if elts:
            context.gen_galois_keys_for_elements(elts)
        return FheTask(self.task_dir, device=context.device, **task_kwargs)

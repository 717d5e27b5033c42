"""LattiSense on PyTorch and CUDA: the BFV and CKKS engines, CKKS bootstrapping,
threshold BFV, the compiled-task runtime and its foreign-library boundary (the
raw-RNS C ABI), the frontend that compiles its task graphs (``frontend/``),
the four-step NTT as tensor-core matrix products (``ops/ntt_mxu.py``) and the
device mesh (``parallel/``: the op axis, the limb-sharded key switch and its
pipelines, the coefficient-sharded NTT and key switches, the sharded engine
views and bootstraps over the coefficient and limb axes, the task runtime on
every axis, over ``torch.distributed`` with one process a rank), the model
zoo (``models/``) and the example runners (``examples/``), ported from
``lattisense_tpu``.

The JAX package stays the reference; this package computes the same values
bit for bit. Residues travel as ``torch.int64`` tensors holding values in
``[0, q)`` and follow the reference's word conventions exactly on both
machine words (Montgomery R = 2^32 or 2^64, Shoup companions floor(w·R/q),
64-bit constants held as int64 bit patterns), so every intermediate matches
the JAX package's ``word_bits=32`` path (the 31-bit chains of
``BfvParams.create_tpu_param``) and its ``word_bits=64`` path (the
``parameter.json`` chains of ``BfvParams.create``).

Plain PyTorch carries the code around the kernels. The hot kernels are CUDA
C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes`` (``ops/``): a CUDA tensor always takes the kernel, a CPU tensor its
plain PyTorch twin in the same module.

Entry points run on the card unless the caller passes ``device='cpu'``.
"""

import torch

__version__ = '0.1.0'


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``'cuda'`` when ``device`` is None.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    an entry point never carries on silently on the CPU.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'lattisense_torch: CUDA is not available; pass device="cpu" '
                'to run the plain PyTorch path on the CPU')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    return dev


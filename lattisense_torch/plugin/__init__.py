"""Plug-in offload: run compiled tasks on foreign raw-RNS buffers.

Port of ``lattisense_tpu/plugin``, the counterpart of the reference's
plug-in band (plug-in/SEAL/acc/runner.cpp, plug-in/lattigo/acc/
gpu_runner.go): a foreign FHE library (SEAL, Lattigo, ...) exports its
ciphertexts and keys as the C structs of ``abi.py`` (abi/c_types.h) and
offloads a compiled task to this package's runtime on the card, importing
the results back into its own types. ``capi`` is the Python half of the C
ABI shim (``csrc/plugin/lattisense_plugin.cpp``, built by
``ops/plugin_build.py``).
"""

from .foreign_task import ForeignTask, ForeignVectorArgument  # noqa: F401

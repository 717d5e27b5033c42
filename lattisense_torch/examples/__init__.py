"""The example runners of ``lattisense_tpu``'s ``examples/`` on the port.

Each runner is a module: ``python -m lattisense_torch.examples.<name> [--toy]
[--n N] [--cpu]`` from the repository root, or ``main(argv) -> dict`` in
process (the values it checked). ``--toy`` shrinks the ring to n=64 and
keeps the card; ``--cpu`` runs the plain PyTorch twins on the CPU. Without
``--cpu`` and without a card a runner raises (``resolve_device``).
"""

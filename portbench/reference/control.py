"""The controls: the reference's own results computed one precision below
what each configuration delivers, put in the program's place to show that
the comparison deciding ``correct`` fails them.

- BFV is exact mod t = 65537, which needs 17 bits: the control holds the
  plaintext result in int16.
- CKKS at scale 2^40 and n = 2^16 delivers about 20 bits a slot: the
  control computes the slots in float16 (11 significant bits).
"""

import numpy as np
import torch


def int16(x, t: int) -> np.ndarray:
    """x (integers in [0, t)) stored in int16 and read back mod t."""
    return np.asarray(x, dtype=np.int64).astype(np.int16).astype(np.int64) % t


def float16_product(a, b) -> np.ndarray:
    """The slotwise product of complex a and b with every part and every
    product rounded to float16."""
    def h(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(torch.float16)
    ar, ai, br, bi = h(a.real), h(a.imag), h(b.real), h(b.imag)
    re, im = ar * br - ai * bi, ar * bi + ai * br
    return re.double().numpy() + 1j * im.double().numpy()

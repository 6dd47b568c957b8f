"""The control's lower precision: float32 values rounded to TF32.

The configurations state float32 with TF32 off (the port's material
gathers raise when TF32 products are allowed), so the control is the
reference computed in TF32, the step below: 10 explicit mantissa bits
instead of 23, rounded to nearest even.  ``tf32`` rounds a float32
tensor so; under autograd it passes the gradient straight through, as a
TF32 product's backward does.
"""

from __future__ import annotations

import torch

DROP = 13  # float32 keeps 23 mantissa bits, TF32 10


def _round(x):
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> DROP) & 1
    bits = (bits + ((1 << (DROP - 1)) - 1) + lsb) & ~((1 << DROP) - 1)
    return bits.view(torch.float32)


def tf32(x):
    if x.dtype != torch.float32:
        return x
    if x.requires_grad:
        return x + (_round(x.detach()) - x).detach()
    return _round(x)

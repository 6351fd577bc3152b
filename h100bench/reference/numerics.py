"""The precision the reference computes in.

`Numerics.reference()` computes every product in float32 with TF32 off.
`Numerics.control()` is the control of the comparison: the same reference,
one precision step below what the configurations state. Their convolutions
and linear layers multiply bfloat16 operands, so the control rounds every
product's operands to float8 e4m3 (scaled per tensor to its largest value,
as an fp8 path would); their post-processing is float32, so the control's
runs in bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FP8_MAX = 448.0                 # largest finite float8 e4m3fn


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t):
    """t rounded to float8 e4m3 at a per-tensor scale, back in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (t.float() * s).to(torch.float8_e4m3fn).float() / s


def bf16_np(a):
    """float32 array rounded to bfloat16 (nearest even), as float32."""
    a = np.asarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@dataclasses.dataclass(frozen=True)
class Numerics:
    name: str
    operand: object = None          # rounding of a product's operands
    post_bf16: bool = False         # post-processing in bfloat16

    @staticmethod
    def reference():
        return Numerics('float32')

    @staticmethod
    def control():
        return Numerics('control: fp8 operands, bf16 post-processing',
                        operand=fp8, post_bf16=True)

    def q(self, t):
        return t if self.operand is None else self.operand(t)

    def post(self, a):
        """An array of the post-processing, in its precision."""
        a = np.asarray(a, np.float32)
        return bf16_np(a) if self.post_bf16 else a

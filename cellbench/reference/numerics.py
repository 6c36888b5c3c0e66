"""Matrix products at a stated precision.

``fp32`` is full float32 (TF32 off).  The lower precisions make the
controls: the operands are rounded to the lower format and the products
accumulated in float32, which is what the card's TF32, bf16 and fp8
tensor-core paths do.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0           # largest finite float8_e4m3fn


def round_mantissa(x: torch.Tensor, drop: int) -> torch.Tensor:
    """float32 rounded to nearest-even with ``drop`` low mantissa bits
    cleared (13: TF32, 16: bfloat16)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8_e4m3fn with one scale per tensor."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product at ``precision`` (float32 storage)."""
    x = x.to(torch.float32)
    if precision == "fp32":
        return x
    if precision == "tf32":
        return _ste(x, round_mantissa(x.detach(), 13))
    if precision == "bf16":
        return _ste(x, round_mantissa(x.detach(), 16))
    if precision == "fp8":
        return _ste(x, to_fp8(x.detach()))
    raise ValueError(f"precision {precision!r}: expected one of "
                     f"{PRECISIONS}")


def _ste(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` in the forward, the gradient of ``x`` in the backward
    (the rounding's own derivative is zero almost everywhere)."""
    return x + (rounded - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           precision: str) -> torch.Tensor:
    """``x @ w.T + b`` with the operands at ``precision``."""
    return torch.matmul(cast(x, precision), cast(w, precision).t()) + b


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str
           ) -> torch.Tensor:
    return torch.matmul(cast(a, precision), cast(b, precision))


def full_float32() -> None:
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

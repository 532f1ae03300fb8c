"""The arithmetic of the plain references: float32 with TF32 off, or a
lower precision for the control.

`matmul(x, w, mode)` is every dense product of the references:
  * "fp32": x @ w in float32;
  * "fp8": both operands rounded to float8 e4m3 first (per-tensor scale
    for the weight, per-row scale for the activations, each amax / 448),
    then multiplied in float32. This is the control: the reference put in
    the program's place one precision below the bfloat16 that the
    configurations state. In a backward the rounding passes the gradient
    straight through.
"""

from __future__ import annotations

import torch

MODES = ("fp32", "fp8")
_E4M3_MAX = 448.0


def fp32_only() -> None:
    """TF32 off: a float32 product on the card stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under an amax scale (per tensor, or per
    slice along `dim`), back in x's dtype; gradient straight through."""
    amax = (x.detach().abs().amax() if dim is None
            else x.detach().abs().amax(dim=dim, keepdim=True))
    scale = amax.clamp_min(1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, mode: str = "fp32"
           ) -> torch.Tensor:
    if mode == "fp32":
        return x @ w
    if mode == "fp8":
        return round_fp8(x, dim=-1) @ round_fp8(w)
    raise ValueError(f"unknown precision {mode!r}")

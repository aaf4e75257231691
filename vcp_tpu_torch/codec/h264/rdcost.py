"""Float32 rate-distortion cost pieces shared by the t8 decision of the P
step and the RD intra frame (``vcp_tpu``'s ``gop_ops._residual_recon``
and ``intra_rd``): cost = SSD + lambda2 * bits, compared with ``<`` or an
argmin.

Every decision must come out the same on ``cpu`` and ``cuda``, so nothing
here depends on a device's ``pow`` / ``log2`` or on its reduction order:

* ``lam2_for_qp`` computes 0.9 * 2^((qp-12)/3) once on the host and hands
  back a Python float that holds a float32 value;
* ``level_bits`` reads the per-level proxy 2*log2(|z|+1)+1.7 from a
  float32 table made on the host (levels are clamped to ``MAX_LEVEL`` by
  every quantizer) and sums it in float64: each entry is 0 or a float32
  of at least 3.7 and so a multiple of 2^-22, a sum of a few hundred of
  them stays below 2^15, and 37 bits fit float64's 53, so the float64
  sum is exact in any order and its rounding to float32 is the same
  everywhere;
* ``ssd`` sums squared int32 differences in int32 (at most 256 * 255^2 <
  2^24, exact in float32);
* ``first_argmin`` returns the first index of the minimum, the tie rule
  of ``jnp.argmin`` (``torch.argmin`` does not promise one).

The remaining arithmetic of a cost (one float32 multiply and a few adds,
in the order the reference writes them) is single IEEE operations.
Against ``vcp_tpu`` the bit sums can differ in the last float32 bits
(XLA sums in float32, in its own order), so a cost is compared with a
relative tolerance and only the decisions, levels and recon exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import constant
from ...ops.transform import MAX_LEVEL


def lam2_for_qp(qp: int) -> float:
    """x264's lambda2, 0.9 * 2^((qp-12)/3), as a float32 value."""
    x = np.float32(qp - 12) / np.float32(3.0)
    p = np.float32(2.0 ** float(x))
    return float(np.float32(0.9) * p)


def _bits_table() -> np.ndarray:
    a = np.arange(MAX_LEVEL + 1, dtype=np.float64)
    lg = np.log2(a + 1.0).astype(np.float32)
    tab = np.float32(2.0) * lg + np.float32(1.7)
    tab[0] = 0.0
    return tab.astype(np.float32)


def level_bits(levels: torch.Tensor, dims) -> torch.Tensor:
    """Bit proxy of ``levels``, 2*log2(|z|+1)+1.7 per nonzero level,
    summed over ``dims`` (float32, exact)."""
    tab = constant("level_bits", _bits_table(), levels.device, torch.float32)
    return tab[levels.abs().long()].sum(dim=dims, dtype=torch.float64) \
        .to(torch.float32)


def ssd(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    """Sum of squared differences of int32 samples over ``dims``, as
    float32."""
    d = a - b
    return (d * d).sum(dim=dims, dtype=torch.int32).to(torch.float32)


def first_argmin(cost: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first minimum of ``cost`` along ``dim`` (int64)."""
    n = cost.shape[dim]
    shape = [1] * cost.dim()
    shape[dim] = n
    idx = torch.arange(n, device=cost.device).reshape(shape)
    least = cost.min(dim=dim, keepdim=True).values
    return torch.where(cost == least, idx, n).min(dim=dim).values

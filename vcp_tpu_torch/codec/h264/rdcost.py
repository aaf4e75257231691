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
* ``mv_bits`` and ``se_bits`` (the MV-rate proxies of the B mode
  decision and of the partition trial, both of ``log2`` of a vector
  component) read float32 tables made on the host the same way;
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


def _bits_table(max_level: int = MAX_LEVEL) -> np.ndarray:
    a = np.arange(max_level + 1, dtype=np.float64)
    lg = np.log2(a + 1.0).astype(np.float32)
    tab = np.float32(2.0) * lg + np.float32(1.7)
    tab[0] = 0.0
    return tab.astype(np.float32)


def level_bits(levels: torch.Tensor, dims,
               max_level: int = MAX_LEVEL) -> torch.Tensor:
    """Bit proxy of ``levels``, 2*log2(|z|+1)+1.7 per nonzero level,
    summed over ``dims`` (float32, exact); ``max_level`` bounds |z|
    (H.264's quantizers clamp at ``MAX_LEVEL``, HEVC's at 32767)."""
    tab = constant(f"level_bits{max_level}", _bits_table(max_level),
                   levels.device, torch.float32)
    return tab[levels.abs().long()].sum(dim=dims, dtype=torch.float64) \
        .to(torch.float32)


# |mv| and |mvd| in quarter-pel stay far below: a vector is bounded by
# 4 * (search range + 1) <= 100 at the ported efforts
MV_CAP = 1023


def _log2_table(step: float) -> np.ndarray:
    a = np.arange(MV_CAP + 1, dtype=np.float64)
    return np.log2(step * a + 1.0).astype(np.float32)


def _se_table() -> np.ndarray:
    tab = np.float32(2.0) * _log2_table(2.0) + np.float32(1.0)
    tab[0] = 1.0
    return tab.astype(np.float32)


def mv_bits(mv: torch.Tensor) -> torch.Tensor:
    """Bit proxy of a quarter-pel vector (..., 2), 2*log2(|x|+1) +
    2*log2(|y|+1) + 2, float32."""
    tab = constant("log2_mv", _log2_table(1.0), mv.device, torch.float32)
    a = mv.abs().clamp_max(MV_CAP).long()
    return 2.0 * tab[a[..., 0]] + 2.0 * tab[a[..., 1]] + 2.0


def se_bits(v: torch.Tensor) -> torch.Tensor:
    """se(v) Exp-Golomb length proxy per component, 1 for 0 and else
    2*log2(2|v|+1) + 1, float32."""
    tab = constant("se_bits", _se_table(), v.device, torch.float32)
    return tab[v.abs().clamp_max(MV_CAP).long()]


def exact_sum(a: torch.Tensor, dims) -> torch.Tensor:
    """float32 sum of a few float32 terms over ``dims``, summed in float64
    (exact) and rounded once, so the order of the terms does not
    matter."""
    return a.sum(dim=dims, dtype=torch.float64).to(torch.float32)


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

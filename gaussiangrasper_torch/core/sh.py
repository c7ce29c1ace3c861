"""Real spherical-harmonics basis (degrees 0..4) and colour evaluation
(counterpart of the JAX package's core/sh.py).

The active degree is a mask, not a branch: bands above it contribute zero,
so one code path serves every step of the SH schedule."""

from __future__ import annotations

from typing import Union

import torch

MAX_DEGREE = 4
NUM_BASES = (MAX_DEGREE + 1) ** 2  # 25

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

# degree of each of the 25 basis functions, for masking
_BASIS_DEGREE = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7 + (4,) * 9


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """All 25 real SH basis functions at unit directions (..., 3) -> (..., 25)."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    bases = [
        _C0 * one,
        -_C1 * y,
        _C1 * z,
        -_C1 * x,
        _C2[0] * xy,
        _C2[1] * yz,
        _C2[2] * (2.0 * zz - xx - yy),
        _C2[3] * xz,
        _C2[4] * (xx - yy),
        _C3[0] * y * (3.0 * xx - yy),
        _C3[1] * xy * z,
        _C3[2] * y * (4.0 * zz - xx - yy),
        _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        _C3[4] * x * (4.0 * zz - xx - yy),
        _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3.0 * yy),
        _C4[0] * xy * (xx - yy),
        _C4[1] * yz * (3.0 * xx - yy),
        _C4[2] * xy * (7.0 * zz - 1.0),
        _C4[3] * yz * (7.0 * zz - 3.0),
        _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
        _C4[5] * xz * (7.0 * zz - 3.0),
        _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
        _C4[7] * xz * (xx - 3.0 * yy),
        _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
    ]
    return torch.stack(bases, dim=-1)


def eval_sh(
    active_degree: Union[int, torch.Tensor], dirs: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """SH colours (..., C) from unit dirs (..., 3) and coeffs (..., K, C),
    K <= 25. Callers add +0.5 and clamp (as the JAX model does)."""
    k = coeffs.shape[-2]
    basis = sh_basis(dirs)[..., :k]
    deg = torch.tensor(_BASIS_DEGREE[:k], device=dirs.device)
    basis = basis * (deg <= active_degree).to(basis.dtype)
    return torch.einsum("...k,...kc->...c", basis, coeffs)

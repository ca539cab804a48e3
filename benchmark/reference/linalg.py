"""Batched small-matrix linear algebra for the GBP core: the benchmark's
frozen copy of magics_tpu_torch/core/linalg.py, with the TF32 control.

DOFS = 4 and factors have at most two neighbours, so every inverse is a
batched closed-form 4x4 and the Schur marginalisation is a two-block formula
on `[..., 4, 4]` tensors. Products are spelled as broadcast-multiply-sum, as
in the JAX package: no library matmul, so no TF32 rounding can reach them.
Never use `torch.linalg.inv` here: the endpoint priors of 1e30 overflow the
determinant in float32, which is why `inv4_rowscaled` exists.
"""

from __future__ import annotations

import contextlib

import torch


class _Products:
    """How the matrix products round their operands: not at all, or to
    TF32 (the lower-precision control of the benchmark's comparison)."""

    tf32 = False


_PRODUCTS = _Products()


@contextlib.contextmanager
def tf32_products():
    """Within this block every matrix product (mm, mtm, mv) rounds its
    operands to TF32, 10 bits of mantissa to nearest, as a TF32 tensor-core
    product does before it accumulates in float32."""
    _PRODUCTS.tf32 = True
    try:
        yield
    finally:
        _PRODUCTS.tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 (round to nearest on the 13 low mantissa bits of
    float32), returned in x's dtype."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    keep = ~torch.isfinite(x.float())
    return torch.where(keep, x.float(), rounded).to(x.dtype)


def _operands(a: torch.Tensor, b: torch.Tensor):
    if _PRODUCTS.tf32:
        return to_tf32(a), to_tf32(b)
    return a, b


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched tiny matmul [..., n, k] @ [..., k, m] as multiply-reduce."""
    a, b = _operands(a, b)
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a^T @ b for [..., k, n], [..., k, m] -> [..., n, m]."""
    a, b = _operands(a, b)
    return (a[..., :, :, None] * b[..., :, None, :]).sum(dim=-3)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched tiny matvec [..., n, k] @ [..., k]."""
    a, v = _operands(a, v)
    return (a * v[..., None, :]).sum(dim=-1)


def inv4(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form inverse of [..., 4, 4] matrices via cofactors.

    Returns (inverse, det). Where det == 0 the inverse holds inf/nan; the
    caller guards.
    """
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]
    # 2x2 sub-determinants of rows 0,1 (c) and rows 2,3 (d)
    c01 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    c02 = a[0][0] * a[1][2] - a[0][2] * a[1][0]
    c03 = a[0][0] * a[1][3] - a[0][3] * a[1][0]
    c12 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c13 = a[0][1] * a[1][3] - a[0][3] * a[1][1]
    c23 = a[0][2] * a[1][3] - a[0][3] * a[1][2]

    d01 = a[2][0] * a[3][1] - a[2][1] * a[3][0]
    d02 = a[2][0] * a[3][2] - a[2][2] * a[3][0]
    d03 = a[2][0] * a[3][3] - a[2][3] * a[3][0]
    d12 = a[2][1] * a[3][2] - a[2][2] * a[3][1]
    d13 = a[2][1] * a[3][3] - a[2][3] * a[3][1]
    d23 = a[2][2] * a[3][3] - a[2][3] * a[3][2]

    det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01

    adj = [
        [
            a[1][1] * d23 - a[1][2] * d13 + a[1][3] * d12,
            -a[0][1] * d23 + a[0][2] * d13 - a[0][3] * d12,
            a[3][1] * c23 - a[3][2] * c13 + a[3][3] * c12,
            -a[2][1] * c23 + a[2][2] * c13 - a[2][3] * c12,
        ],
        [
            -a[1][0] * d23 + a[1][2] * d03 - a[1][3] * d02,
            a[0][0] * d23 - a[0][2] * d03 + a[0][3] * d02,
            -a[3][0] * c23 + a[3][2] * c03 - a[3][3] * c02,
            a[2][0] * c23 - a[2][2] * c03 + a[2][3] * c02,
        ],
        [
            a[1][0] * d13 - a[1][1] * d03 + a[1][3] * d01,
            -a[0][0] * d13 + a[0][1] * d03 - a[0][3] * d01,
            a[3][0] * c13 - a[3][1] * c03 + a[3][3] * c01,
            -a[2][0] * c13 + a[2][1] * c03 - a[2][3] * c01,
        ],
        [
            -a[1][0] * d12 + a[1][1] * d02 - a[1][2] * d01,
            a[0][0] * d12 - a[0][1] * d02 + a[0][2] * d01,
            -a[3][0] * c12 + a[3][1] * c02 - a[3][2] * c01,
            a[2][0] * c12 - a[2][1] * c02 + a[2][2] * c01,
        ],
    ]
    adj = torch.stack([torch.stack(row, dim=-1) for row in adj], dim=-2)
    return adj / det[..., None, None], det


def inv4_rowscaled(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-equilibrated batched 4x4 inverse.

    Each row is scaled by its max |entry| before the cofactor inverse:
    Lam = D^-1 M with D = diag(1/rowmax), so Lam^-1 = M^-1 D. Returns
    (inverse, det_of_scaled_matrix).
    """
    rowmax = m.abs().amax(dim=-1)  # [..., 4]
    d = torch.where(rowmax > 0.0, 1.0 / rowmax, torch.ones_like(rowmax))
    inv_scaled, det = inv4(m * d[..., :, None])
    return inv_scaled * d[..., None, :], det


def belief_covariance(lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert a belief precision [..., 4, 4] with a residual sanity check:
    valid where det != 0, the inverse is finite and ||lam @ cov - I||_inf
    < 1e-4 (magics_tpu core/linalg.py:belief_covariance). The residual sums
    the exact products of the float32 operands in float64: on a
    rank-deficient precision, a float32 sum of rounded products can cancel
    to exactly the identity and pass, where the JAX package's XLA dot (fused
    multiply-adds, which keep the products' low bits) fails it. Such
    precisions arise within a tick at the swarm-scale workload's 12.8 km
    coordinates; the slot kernels form the residual the same way."""
    cov, det = inv4_rowscaled(lam)
    eye = torch.eye(lam.shape[-1], dtype=torch.float64, device=lam.device)
    resid = (mm(lam.double(), cov.double()) - eye).abs().amax(dim=(-2, -1))
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    valid = (det != 0.0) & finite & (resid < 1e-4)
    return cov, valid


def marginalize_two_block(
    eta_a: torch.Tensor,
    eta_b: torch.Tensor,
    lam_aa: torch.Tensor,
    lam_ab: torch.Tensor,
    lam_ba: torch.Tensor,
    lam_bb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Schur marginalisation of an 8-dof factor potential onto block a.

    Returns (eta_msg, lam_msg, valid); the message is zeroed where ~valid:
    a singular (|det| <= 1e-6 after row scaling), non-finite, insane
    (> 4 * scale + 1) or negligible (<= rtol * scale) marginal is empty, as
    in magics_tpu core/linalg.py:marginalize_two_block.
    """
    lam_bb_inv, det = inv4_rowscaled(lam_bb)
    lam_ab_bbinv = mm(lam_ab, lam_bb_inv)
    eta_msg = eta_a - mv(lam_ab_bbinv, eta_b)
    lam_msg = lam_aa - mm(lam_ab_bbinv, lam_ba)

    finite = torch.isfinite(lam_msg).all(dim=-1).all(dim=-1) & torch.isfinite(
        eta_msg
    ).all(dim=-1)
    scale_aa = lam_aa.abs().amax(dim=(-2, -1))
    lam_msg_scale = lam_msg.abs().amax(dim=(-2, -1))
    sane = lam_msg_scale <= 4.0 * scale_aa + 1.0
    rtol = 1e-4 if lam_msg.dtype == torch.float32 else 1e-12
    negligible = lam_msg_scale <= rtol * scale_aa
    valid = (det.abs() > 1e-6) & finite & sane & ~negligible

    ok = valid[..., None]
    eta_msg = torch.where(ok, eta_msg, torch.zeros_like(eta_msg))
    lam_msg = torch.where(ok[..., None], lam_msg, torch.zeros_like(lam_msg))
    return eta_msg, lam_msg, valid

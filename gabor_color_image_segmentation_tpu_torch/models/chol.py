"""Batched Cholesky + triangular inverse, kernel K9, and the GMM's fused
moments -> parameters step, kernel K10 (counterparts of the JAX package's
models/chol_pallas.py::precision_chol_pallas and
::precision_chol_params_pallas).

K9 maps (M, d, d) SPD float32 matrices to (P^T = L^-1, lower; diag L), with
L = cholesky(cov): sklearn's precision Cholesky, whose log-determinant is
-sum(log diag L). The GMM's EM loop factors B * k covariances per
iteration (M = 40 at config2's batch 8, d = 39).

K9 (csrc/precision_chol.cu) replaces ``_kernel``: one warp per matrix,
the matrix and its inverse in shared memory sized at launch, L and L^-1
formed in one right-looking LDL^T sweep of four columns a step (each
step's rank-4 updates of the trailing rows at once, lanes over columns,
no serial dot, one warp sync a step), for d <= 128 as the reference. The
plain version is ``torch.linalg.cholesky`` + ``solve_triangular`` (LAPACK on
the CPU, cuSOLVER on the card): it serves CPU tensors and the comparison,
and is no part of the CUDA route.

K10 (the same source) replaces ``_params_kernel``: one EM pass's moments
(counts, sums, scatter) -> sklearn's parameters (``_moments_to_params``)
-> K8's inputs (P^T, bias = P^T mu, const = log w + log det P - d/2 log
2 pi; ``_params_to_kernel_inputs``) in one launch, one block per matrix,
for d <= 127 as the reference. The EM loop runs it only behind
models/gmm_fused.py's ``_FUSED_PREP`` switch, off by default as in the
reference. Its plain version is the two steps with ``precision_chol_plain``.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.gmm import _LOG2PI

# The card's limits are the reference's: precision_chol_pallas takes
# d <= 128 (its lane width) and precision_chol_params_pallas dp <= 128 with
# the ones row at index d < dp.
D_MAX = 128
D_PARAMS_MAX = D_MAX - 1


def precision_chol_plain(covs: torch.Tensor):
    """Plain PyTorch version of K9 (same contract as precision_chol)."""
    chol = torch.linalg.cholesky(covs)
    eye = torch.eye(covs.shape[-1], dtype=covs.dtype, device=covs.device)
    pt = torch.linalg.solve_triangular(chol, eye.expand_as(covs), upper=False)
    return pt, torch.diagonal(chol, dim1=-2, dim2=-1)


def precision_chol(covs: torch.Tensor):
    """(M, d, d) SPD float32 -> (P^T (M, d, d) lower float32, diag of the
    Cholesky factor (M, d) float32)."""
    _kernels.check(covs.dim() == 3 and covs.shape[1] == covs.shape[2],
                   f"covs must be (M, d, d), got {tuple(covs.shape)}")
    _kernels.check(covs.dtype == torch.float32, f"covs must be float32, got {covs.dtype}")
    if _kernels.use_plain(covs):
        return precision_chol_plain(covs)
    m, d, _ = covs.shape
    _kernels.check(1 <= d <= D_MAX, f"the CUDA kernel takes 1 <= d <= {D_MAX} (the "
                   f"reference's precision_chol_pallas limit), got {d}")
    covs = covs.contiguous()
    pt = torch.empty_like(covs)
    diag = torch.empty((m, d), dtype=torch.float32, device=covs.device)
    _kernels.launch("gcis_precision_chol", covs.data_ptr(), pt.data_ptr(),
                    diag.data_ptr(), m, d, outputs=(pt, diag))
    precision_chol.launches += 1
    return pt, diag


precision_chol.launches = 0


def _moments_to_params(counts, sums, scatter, n: int, reg_covar: float):
    """Moments -> (weights (B, k), means (B, k, D), covariances (B, k, D, D))
    with sklearn's formulas (counts + 10 eps, E[x x^T] - mu mu^T + reg I)."""
    nk = counts + 10.0 * torch.finfo(torch.float32).eps
    means = sums / nk[:, :, None]
    cov = scatter / nk[:, :, None, None] - means[:, :, :, None] * means[:, :, None, :]
    eye = torch.eye(sums.shape[2], dtype=torch.float32, device=sums.device)
    return nk / n, means, cov + reg_covar * eye


def _params_to_kernel_inputs(weights, means, covs, plain: bool = False):
    """(weights, means, covariances) -> K8's (P^T, bias, const). P^T comes
    from K9 on a CUDA tensor (``precision_chol_plain`` with ``plain``);
    log det P = -sum log diag L."""
    b, k, d = means.shape
    factor = precision_chol_plain if plain else precision_chol
    pt, diag = factor(covs.reshape(b * k, d, d))
    pt, diag = pt.reshape(b, k, d, d), diag.reshape(b, k, d)
    bias = torch.matmul(pt, means[..., None])[..., 0]
    const = torch.log(weights) - torch.log(diag).sum(dim=2) - 0.5 * d * _LOG2PI
    return pt, bias, const


def precision_chol_params_plain(counts, sums, scatter, m_rows: int, reg_covar: float):
    """Plain PyTorch version of K10 (same contract as precision_chol_params)."""
    return _params_to_kernel_inputs(
        *_moments_to_params(counts, sums, scatter, m_rows, reg_covar), plain=True)


def precision_chol_params(counts: torch.Tensor, sums: torch.Tensor, scatter: torch.Tensor,
                          m_rows: int, reg_covar: float):
    """One EM pass's moments -> K8's inputs, in one launch.

    counts (B, k), sums (B, k, d), scatter (B, k, d, d) float32, taken over
    ``m_rows`` pixels. Returns (P^T (B, k, d, d) lower, bias (B, k, d),
    const (B, k)) float32, as ``_params_to_kernel_inputs`` of
    ``_moments_to_params`` gives them."""
    _kernels.check(sums.dim() == 3, f"sums must be (B, k, d), got {tuple(sums.shape)}")
    b, k, d = sums.shape
    for name, t, shape in (("counts", counts, (b, k)), ("sums", sums, (b, k, d)),
                           ("scatter", scatter, (b, k, d, d))):
        _kernels.check(tuple(t.shape) == shape and t.dtype == torch.float32,
                       f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    _kernels.check(m_rows >= 1, f"m_rows must be >= 1, got {m_rows}")
    if _kernels.use_plain(counts, sums, scatter):
        return precision_chol_params_plain(counts, sums, scatter, m_rows, reg_covar)
    _kernels.check(1 <= d <= D_PARAMS_MAX, f"the CUDA kernel takes 1 <= d <= {D_PARAMS_MAX} "
                   f"(the reference's precision_chol_params_pallas limit), got {d}")
    counts, sums, scatter = counts.contiguous(), sums.contiguous(), scatter.contiguous()
    pt = torch.empty_like(scatter)
    bias = torch.empty_like(sums)
    const = torch.empty_like(counts)
    _kernels.launch("gcis_precision_chol_params", counts.data_ptr(), sums.data_ptr(),
                    scatter.data_ptr(), pt.data_ptr(), bias.data_ptr(), const.data_ptr(),
                    b * k, d, float(m_rows), float(reg_covar), outputs=(pt, bias, const))
    precision_chol_params.launches += 1
    return pt, bias, const


precision_chol_params.launches = 0

"""Batched Cholesky + triangular inverse, kernel K9 (counterpart of the JAX
package's models/chol_pallas.py::precision_chol_pallas).

Maps (M, d, d) SPD float32 matrices to (P^T = L^-1, lower; diag L), with
L = cholesky(cov): sklearn's precision Cholesky, whose log-determinant is
-sum(log diag L). The GMM's EM loop factors B * k covariances per
iteration (M = 40 at config2's batch 8, d = 39).

K9 (csrc/precision_chol.cu) replaces ``_kernel``: one thread block per
matrix, the matrix in shared memory, a right-looking Cholesky, then forward
substitution for L^-1, in the reference kernel's order of operations. The
plain version is ``torch.linalg.cholesky`` + ``solve_triangular`` (LAPACK on
the CPU, cuSOLVER on the card): it serves CPU tensors and the comparison,
and is no part of the CUDA route.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels

D_MAX = 64  # matrix order the kernel's shared memory is sized for


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
    _kernels.check(1 <= d <= D_MAX, f"the CUDA kernel takes 1 <= d <= {D_MAX}, got {d}")
    covs = covs.contiguous()
    pt = torch.empty_like(covs)
    diag = torch.empty((m, d), dtype=torch.float32, device=covs.device)
    _kernels.launch("gcis_precision_chol", covs.data_ptr(), pt.data_ptr(),
                    diag.data_ptr(), m, d)
    precision_chol.launches += 1
    return pt, diag


precision_chol.launches = 0

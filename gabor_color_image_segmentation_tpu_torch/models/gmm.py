"""Per-image full-covariance GMM in plain PyTorch (counterpart of the JAX
package's models/gmm.py): sklearn's EM semantics, float32 throughout.

- init: hard responsibilities from the deterministic k-means
  (models/kmeans.py, float32);
- M-step: weights, means, and covariances by E[x x^T] - mu mu^T plus
  ``reg_covar`` on the diagonal;
- E-step: Cholesky factor and triangular solve for the Mahalanobis
  distances, log-sum-exp responsibilities;
- ``tol`` > 0: sklearn's rule per image, an image whose mean
  log-likelihood moved by less than tol keeps its parameters from then on
  (done with ``torch.where`` on the device, as the reference's vmapped
  while loop freezes each image, so the host never waits inside the loop);
- ``fit_pool``: the fit runs on the grid pooled ``gmm_fit_levels`` times,
  ``refine_iters`` full-resolution EM passes follow, then the labels.

This is the reference's XLA solver, the with-features path's GMM where the
fused one does not apply (``subsample`` > 1, k > 8, N outside [4,096,
2,000,000]); the reference computes it in XLA, so no kernel is owed. Every
function takes one image (N, D) or a batch (B, N, D). The fused solver is
``models/gmm_fused.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch.models.kmeans import _batched, kmeans, pool2x2

_LOG2PI = 1.8378770664093453
_EPS32 = float(torch.finfo(torch.float32).eps)


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (B, k)
    means: torch.Tensor  # (B, k, D)
    covs: torch.Tensor  # (B, k, D, D)


def gmm_fit_levels(h: int, w: int, fit_pool: int) -> Tuple[int, int, int]:
    """(pooled h, pooled w, levels): the number of 2x2 poolings the fit
    grid takes, at most ``fit_pool``; each level needs a grid of at least
    4x4 and at least 4096 pooled pixels."""
    lv = 0
    while lv < fit_pool and h >= 4 and w >= 4 and (h // 2) * (w // 2) >= 4096:
        h, w = h // 2, w // 2
        lv += 1
    return h, w, lv


def _m_step(x: torch.Tensor, resp: torch.Tensor, reg_covar: float) -> GMMParams:
    """x (B, N, D), resp (B, N, k) float32 -> the parameters."""
    n, d = x.shape[1:]
    nk = resp.sum(dim=1) + 10.0 * _EPS32  # (B, k)
    means = torch.bmm(resp.transpose(1, 2), x) / nk[:, :, None]
    eye = reg_covar * torch.eye(d, dtype=x.dtype, device=x.device)
    covs = []
    for j in range(resp.shape[2]):
        exx = torch.bmm(x.transpose(1, 2), resp[:, :, j:j + 1] * x) / nk[:, j, None, None]
        covs.append(exx - means[:, j, :, None] * means[:, j, None, :] + eye)
    return GMMParams(nk / n, means, torch.stack(covs, dim=1))


def _log_prob(x: torch.Tensor, params: GMMParams) -> torch.Tensor:
    """x (B, N, D) -> (B, N, k) log w_j + log N(x | mu_j, S_j)."""
    d = x.shape[2]
    chol = torch.linalg.cholesky(params.covs)  # (B, k, D, D) lower
    log_det = torch.log(torch.diagonal(chol, dim1=2, dim2=3)).sum(dim=2)  # (B, k)
    lp = []
    for j in range(chol.shape[1]):
        diff = (x - params.means[:, j, None, :]).transpose(1, 2)  # (B, D, N)
        y = torch.linalg.solve_triangular(chol[:, j], diff, upper=False)
        lp.append(-0.5 * (d * _LOG2PI + y.square().sum(dim=1)) - log_det[:, j, None])
    return torch.stack(lp, dim=2) + torch.log(params.weights)[:, None, :]


def _e_step(x: torch.Tensor, params: GMMParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (log responsibilities (B, N, k), mean log-likelihood (B,))."""
    weighted = _log_prob(x, params)
    norm = torch.logsumexp(weighted, dim=2, keepdim=True)
    return weighted - norm, norm.mean(dim=(1, 2))


@_batched
def gmm_fit(
    x: torch.Tensor,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    kmeans_iters: int = 10,
    tol: float = 0.0,
    hw: Optional[Tuple[int, int]] = None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, GMMParams]:
    """x (B, N, D) or (N, D) -> (labels int32 (B, N), responsibilities
    (B, N, k), params). ``tol`` > 0 stops an image once its mean
    log-likelihood moves by less than tol; ``fit_pool`` (with ``hw``) fits
    on the pooled grid and ``refine_iters`` full-resolution passes follow."""
    x = x.to(torch.float32)
    fit_x = x
    if fit_pool > 0:
        h, w = hw
        for _ in range(gmm_fit_levels(h, w, fit_pool)[2]):
            fit_x = pool2x2(fit_x, h, w)
            h, w = h // 2, w // 2
    init_labels, _ = kmeans(fit_x, k, kmeans_iters)
    params = _m_step(fit_x, torch.nn.functional.one_hot(init_labels.long(), k).to(torch.float32),
                     reg_covar)
    b = x.shape[0]
    prev_ll = torch.full((b,), -math.inf, device=x.device)
    go = torch.full((b,), n_iter > 0, dtype=torch.bool, device=x.device)
    for _ in range(n_iter):
        log_resp, ll = _e_step(fit_x, params)
        new = _m_step(fit_x, torch.exp(log_resp), reg_covar)
        if tol == 0.0:
            params = new
            continue
        params = GMMParams(*(torch.where(go.reshape((b,) + (1,) * (p.dim() - 1)), p, q)
                             for p, q in zip(new, params)))
        ll = torch.where(go, ll, prev_ll)
        go = go & ((ll - prev_ll).abs() >= tol)
        prev_ll = ll
    for _ in range(refine_iters):
        log_resp, _ = _e_step(x, params)
        params = _m_step(x, torch.exp(log_resp), reg_covar)
    log_resp, _ = _e_step(x, params)
    return torch.argmax(log_resp, dim=2).to(torch.int32), torch.exp(log_resp), params


@_batched
def gmm_predict(
    x: torch.Tensor,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    subsample: int = 1,
    tol: float = 0.0,
    hw: Optional[Tuple[int, int]] = None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> torch.Tensor:
    """Labels (B, N) int32 (or (N,)). ``subsample`` > 1 fits on every n-th
    pixel (no pooled fit) and labels every pixel with one E-step."""
    if subsample == 1:
        return gmm_fit(x, k, n_iter, reg_covar, 10, tol, hw, fit_pool, refine_iters)[0]
    x = x.to(torch.float32)
    _, _, params = gmm_fit(x[:, ::subsample], k, n_iter, reg_covar, 10, tol)
    log_resp, _ = _e_step(x, params)
    return torch.argmax(log_resp, dim=2).to(torch.int32)

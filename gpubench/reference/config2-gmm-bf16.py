"""Plain reference of config2-gmm-bf16 (config2 in bf16, the per-image
GMM; TF32 off, as ``common.set_policy`` sets it before every reference
run): the 12-kernel bank's energies, the standardised buffer at full
resolution and on the grid pooled ``gmm_fit_pool`` times (each level at least 4x4 and 4,096 pixels), then
the per-image full-covariance GMM with sklearn's formulas: k-means init
(maximin seeds, 10 Lloyd passes, the labels), hard moments, ``n_iter`` EM
iterations on the fit grid with the per-image tol freeze, ``refine_iters``
full-resolution EM passes and the labels of one more.

An EM pass: y_j = P_j^T x - P_j^T mu_j with P_j^T the inverse of the
Cholesky factor of the covariance, log p_j = log w_j - sum log diag L_j
- d/2 log 2 pi - |y_j|^2 / 2, first-index argmax labels, softmax
responsibilities and their moments summed in float64, rounded once.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import common

_LOG2PI = math.log(2.0 * math.pi)
_EPS32 = float(torch.finfo(torch.float32).eps)


def fit_levels(h: int, w: int, fit_pool: int) -> int:
    lv = 0
    while lv < fit_pool and h >= 4 and w >= 4 and (h // 2) * (w // 2) >= 4096:
        h, w = h // 2, w // 2
        lv += 1
    return lv


def _kmeans_labels(x, k: int, iters: int, store):
    """Maximin seeds on x (B, D, n) (the float32 mean, then farthest
    points by ||x||^2 - 2 p . x + ||p||^2, p stored for the cross term),
    ``iters`` Lloyd passes, and the labels under the final centres."""
    n = x.shape[2]
    probe = x.sum(dim=2) / n
    xsq = x.square().sum(dim=1)
    dmin, cols = None, []
    for step in range(k):
        cross = torch.bmm(store(probe)[:, None, :], x)[:, 0]
        d2 = xsq - 2.0 * cross + probe.square().sum(dim=1, keepdim=True)
        dmin = d2 if step < 2 else torch.minimum(dmin, d2)
        idx = torch.argmax(dmin, dim=1)
        probe = torch.gather(x, 2, idx[:, None, None].expand(-1, x.shape[1], 1))[:, :, 0]
        cols.append(probe)
    c = torch.stack(cols, dim=1)

    def assign(c):
        return torch.argmin(c.square().sum(dim=2)[:, :, None] - 2.0 * torch.bmm(store(c), x),
                            dim=1)

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(assign(c), k).to(torch.float32)
        counts = onehot.sum(dim=1)
        new = torch.bmm(x, onehot).transpose(1, 2) / torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, new, c)
    return assign(c)


def _params(counts, sums, scatter, n: int, reg: float):
    """Moments -> (weights, means, covariances): counts + 10 eps,
    E[x x^T] - mu mu^T + reg I."""
    nk = counts + 10.0 * _EPS32
    means = sums / nk[:, :, None]
    cov = scatter / nk[:, :, None, None] - means[:, :, :, None] * means[:, :, None, :]
    eye = torch.eye(sums.shape[2], dtype=torch.float32, device=sums.device)
    return nk / n, means, cov + reg * eye


def _inputs(weights, means, covs):
    """(P^T, P^T mu, log w + log det P - d/2 log 2 pi)."""
    b, k, d = means.shape
    chol = torch.linalg.cholesky(covs.reshape(b * k, d, d))
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    pt = torch.linalg.solve_triangular(chol, eye.expand(b * k, d, d), upper=False)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1).reshape(b, k, d)
    pt = pt.reshape(b, k, d, d)
    bias = torch.matmul(pt, means[..., None])[..., 0]
    const = torch.log(weights) - torch.log(diag).sum(dim=2) - 0.5 * d * _LOG2PI
    return pt, bias, const


def _em_pass(x, pt, bias, const, moments: bool = True):
    y = torch.matmul(pt, x[:, None]) - bias[..., None]  # (B, k, D, N)
    lp = const[..., None] - 0.5 * y.square().sum(dim=2)
    del y
    labels = torch.argmax(lp, dim=1)
    if not moments:
        return labels
    m = lp.max(dim=1, keepdim=True).values
    ex = torch.exp(lp - m)
    se = ex.sum(dim=1, keepdim=True)
    resp = ex / se
    ll = (m + torch.log(se)).sum(dim=(1, 2))
    x64, r64 = x.to(torch.float64), resp.to(torch.float64)
    sums = torch.bmm(r64, x64.transpose(1, 2))
    scatter = torch.matmul(x64[:, None] * r64[:, :, None], x64.transpose(1, 2)[:, None])
    f32 = torch.float32
    return labels, ll, r64.sum(dim=2).to(f32), sums.to(f32), scatter.to(f32)


def _gmm(x, fit, cl: dict, store):
    k, reg, tol = cl["k"], cl["gmm_reg_covar"], cl["gmm_tol"]
    b, _, m = fit.shape
    init = _kmeans_labels(fit, k, 10, store)
    onehot = torch.nn.functional.one_hot(init, k).to(torch.float32).transpose(1, 2)
    sums = torch.bmm(onehot, fit.transpose(1, 2))
    scatter = torch.matmul(fit[:, None] * onehot[:, :, None], fit.transpose(1, 2)[:, None])
    state = _params(onehot.sum(dim=2), sums, scatter, m, reg)
    prev_ll = torch.full((b,), float("-inf"), device=x.device)
    go = torch.full((b,), cl["n_iter"] > 0, dtype=torch.bool, device=x.device)
    for _ in range(cl["n_iter"]):
        _, ll, *mom = _em_pass(fit, *_inputs(*state))
        new = _params(*mom, m, reg)
        ll = ll / m
        if tol == 0.0:
            state = new
            continue
        state = tuple(torch.where(go.reshape((b,) + (1,) * (p.dim() - 1)), p, q)
                      for p, q in zip(new, state))
        ll = torch.where(go, ll, prev_ll)
        go = go & ((ll - prev_ll).abs() >= tol)
        prev_ll = ll
    for _ in range(cl["gmm_refine_iters"]):
        _, _, *mom = _em_pass(x, *_inputs(*state))
        state = _params(*mom, x.shape[2], reg)
    return _em_pass(x, *_inputs(*state), moments=False)


def segment(rgb: torch.Tensor, cfg: dict, store) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the device -> (B, H, W) int64 labels."""
    bsz, h, w, _ = rgb.shape
    cl = cfg["cluster"]
    if cl["method"] != "gmm" or cl["cue_weight"] != "static":
        raise ValueError("this reference runs the GMM on static-weight features")
    lab = common.rgb_to_lab(rgb)
    groups = common.bank_groups(cfg["bank"], rgb.device)
    energies, _ = common.gabor_energies(lab, groups, store, twin=False)
    col = common.color4(lab)
    a, b = common.affine(energies, col, cl, store)
    x = common.normalised(energies, col, a, b, store)
    fit = x  # the fit grid is x itself unless it is pooled
    levels = fit_levels(h, w, cl["gmm_fit_pool"])
    if levels:
        pe, pc = energies, common.color4(lab, store)
        for _ in range(levels):
            pe, pc = common.pool2x2(pe, store), common.pool2x2(pc, store)
        fit = common.normalised(pe, pc, a, b, store)
        del pe, pc
    del energies, col
    return _gmm(x, fit, cl, store).reshape(bsz, h, w)

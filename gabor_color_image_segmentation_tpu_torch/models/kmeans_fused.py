"""Coarse multigrid warm start, kernel K3 (counterpart of the JAX package's
models/kmeans_pallas.py::kmeans_coarse_centers_xp).

K3 (csrc/coarse_centers.cu) replaces ``_coarse_all_kernel``: maximin
seeding and ``coarse_iters`` Lloyd passes on the normalised pooled buffer in
one launch, one thread block per image. The JAX package runs that kernel in
bf16 only and routes f32 through separate maximin and Lloyd passes (with a
fixed-point early exit, identical at the fixed point); the port runs K3 in
both dtypes, so the two differ only in reduction order. The source file
says what bounds it on the H100 (one SM per image).
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import K_MAX


def kmeans_coarse_centers_xp_plain(xp, k: int, d: int, m: int, coarse_iters: int):
    """Plain PyTorch version of K3 (same contract as kmeans_coarse_centers_xp)."""
    x = xp[:, :d, :m].to(torch.float32)  # (B, d, m)

    def rounded(c):  # the cross term sees centres in the storage dtype
        return c.to(xp.dtype).to(torch.float32)

    probe = rounded(x.sum(dim=2) / m)
    dmin = None
    cols = []
    for step in range(k):
        d2 = (x - probe[:, :, None]).square().sum(dim=1)  # (B, m)
        dmin = d2 if step < 2 else torch.minimum(dmin, d2)
        idx = torch.argmax(dmin, dim=1)  # first maximum
        probe = torch.gather(x, 2, idx[:, None, None].expand(-1, d, 1))[:, :, 0]
        cols.append(probe)
    c = torch.stack(cols, dim=1)  # (B, k, d)
    for _ in range(coarse_iters):
        csq = c.square().sum(dim=2)
        scores = csq[:, :, None] - 2.0 * torch.bmm(rounded(c), x)  # (B, k, m)
        onehot = torch.nn.functional.one_hot(torch.argmin(scores, dim=1), k)
        onehot = onehot.to(torch.float32)  # (B, m, k)
        counts = onehot.sum(dim=1)
        new = torch.bmm(x, onehot).transpose(1, 2) / torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, new, c)
    return c


def kmeans_coarse_centers_xp(xp, k: int, d: int, m: int, coarse_iters: int):
    """Maximin seeding + ``coarse_iters`` Lloyd passes on a pooled buffer.

    xp: (B, rows, cols) float32 or bfloat16 with normalised features in rows
    [0, d) and pixels in columns [0, m) (the port's (B, E + 3, m) buffer, or
    the reference's padded xt layout, whose ones-row and padding are not
    read). Returns (B, k, d) float32 centres in normalised feature space."""
    _kernels.check(xp.dim() == 3, f"xp must be (B, rows, cols), got {tuple(xp.shape)}")
    _kernels.check(d <= xp.shape[1] and 1 <= m <= xp.shape[2],
                   f"d={d}, m={m} do not fit xp {tuple(xp.shape)}")
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    _kernels.storage_code(xp.dtype)
    if _kernels.use_plain(xp):
        return kmeans_coarse_centers_xp_plain(xp, k, d, m, coarse_iters)
    xp = xp.contiguous()
    b, rows, cols = xp.shape
    centers = torch.empty((b, k, d), dtype=torch.float32, device=xp.device)
    dmin = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    labels = torch.empty((b, m), dtype=torch.int32, device=xp.device)
    _kernels.launch(
        "gcis_coarse_centers", xp.data_ptr(), centers.data_ptr(),
        dmin.data_ptr(), labels.data_ptr(), b, rows, cols, d, m, k,
        coarse_iters, _kernels.storage_code(xp.dtype),
    )
    kmeans_coarse_centers_xp.launches += 1
    return centers


kmeans_coarse_centers_xp.launches = 0

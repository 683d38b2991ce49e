"""Superpixel affinity graph and spectral normalized cut, batched over the
images (counterpart of the JAX package's models/graph.py).

    superpixel labels -> superpixel mean features F (S, D)
    -> Gaussian affinity W = exp(-|F_i - F_j|^2 / s2), s2 = scale * median
    -> L_sym = I - D^-1/2 W D^-1/2
    -> the n_regions smallest eigenvectors (dense eigh, or subspace iteration)
    -> Ng-Jordan-Weiss row normalisation -> k-means -> a region id per
       superpixel.

Plain PyTorch, as the reference leaves this stage to XLA, but for the
superpixel sums and counts: the reference takes them with a one-hot
matmul (its Pallas moments kernels K16-K18 are off its path), the port
with K17's segmented sum (models/graph_fused.py), which reads the features
once. Everything runs on the device of its inputs with no host sync of its
own.

The entry points keep the reference's names and contracts:
``graph_segment_batch`` (the pipeline's graph stage: SLIC through K11 or
K13, connectivity K14, the batched n-cut, the region ids broadcast to the
pixels by K15), ``ncut_segment`` (one image through ``slic``,
``enforce_connectivity_device`` and ``ncut_from_superpixels``) and
``ncut_from_superpixels`` (one image's n-cut on given superpixels). On CPU
tensors each runs the kernels' plain versions.

Where the two libraries differ the port follows the reference:
``jnp.median`` of an even count is the mean of the two middle values
(``torch.median`` would take the lower one), and ``jnp.linalg.eigh``
symmetrises its input as (A + A^T) / 2 (``torch.linalg.eigh`` reads one
triangle only, and W's products are not exactly symmetric).

The min-cut variant (``mincut_segment``) is the reference's host-side
greedy merge over the superpixel adjacency graph, copied in numpy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.config import PipelineConfig
from gabor_color_image_segmentation_tpu_torch.models.connectivity import (
    enforce_connectivity_fused,
)
from gabor_color_image_segmentation_tpu_torch.models.graph_fused import (
    superpixel_moments_fused_t,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans import kmeans_batched
from gabor_color_image_segmentation_tpu_torch.models.slic import (
    enforce_connectivity_device,
    grid_shape,
    slic,
)
from gabor_color_image_segmentation_tpu_torch.models.slic_fused import slic_batch
from gabor_color_image_segmentation_tpu_torch.ops.lookup import table_lookup
from gabor_color_image_segmentation_tpu_torch.utils.trace import span


def resolve_graph_impls(g, dtype: str) -> Tuple[str, str]:
    """(GraphConfig, pipeline dtype) -> (slic_impl, eig_method), the
    reference's mapping: in float32 parity mode "auto" resolves to "xla"
    and "eigh"; in bfloat16 production mode it stays "auto", which
    ``spectral_labels`` resolves by device (the subspace iteration on the
    card, the dense eigh on the CPU); explicit settings win. Every
    ``slic_impl`` runs the port's one exact-float32 SLIC (slic_batch)."""
    slic_impl, eig_method = g.slic_impl, g.eig_method
    if dtype == "float32":
        if slic_impl == "auto":
            slic_impl = "xla"
        if eig_method == "auto":
            eig_method = "eigh"
    return slic_impl, eig_method


def _eig_on(eig_method: str, device: torch.device) -> str:
    """"auto" -> "subspace" on the card (the reference's choice on its
    TPU), "eigh" elsewhere; any other method as it is."""
    if eig_method != "auto":
        return eig_method
    return "subspace" if device.type == "cuda" else "eigh"


def resolve_eig_method(g, dtype: str, device: torch.device) -> str:
    """(GraphConfig, pipeline dtype, device) -> "eigh" | "subspace":
    ``resolve_graph_impls``' eig_method, "auto" resolved for ``device``."""
    return _eig_on(resolve_graph_impls(g, dtype)[1], device)


def superpixel_means(features: torch.Tensor, labels: torch.Tensor,
                     n_sp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, N) features + (B, N) int32 superpixel labels -> ((B, S, D)
    float32 means, (B, S) float32 counts).

    The sums and counts come from K17 in the features' own dtype (no
    bfloat16 rounding of float32 features), summed in float64 and rounded
    once: the reference's one-hot matmul sums the same exact products in
    float32."""
    sums, counts = superpixel_moments_fused_t(labels, features, n_sp, dtype=features.dtype)
    return sums / torch.clamp(counts, min=1.0)[:, :, None], counts


def _median(x: torch.Tensor) -> torch.Tensor:
    """(B, M) -> (B,) medians as jnp.median takes them: (lo + hi) * 0.5 of
    the two middle values (the same value when M is odd)."""
    v = torch.sort(x, dim=1).values
    m = x.shape[1]
    return (v[:, (m - 1) // 2] + v[:, m // 2]) * 0.5


def affinity_matrix(f: torch.Tensor, sigma: Optional[float] = None,
                    counts: Optional[torch.Tensor] = None,
                    sigma_scale: float = 1.0) -> torch.Tensor:
    """(B, S, D) -> (B, S, S) Gaussian affinity. sigma None: s2 =
    sigma_scale * median(d2), the median taken over a 4x4-strided
    subsample when S > 512. Empty superpixels (counts == 0) get all-zero
    rows and columns."""
    sq = (f * f).sum(dim=2)
    d2 = sq[:, :, None] - 2.0 * (f @ f.transpose(1, 2)) + sq[:, None, :]
    d2 = torch.clamp(d2, min=0.0)
    if sigma is None:
        s = d2.shape[1]
        d2m = d2[:, ::4, ::4] if s > 512 else d2
        med = _median(d2m.reshape(d2.shape[0], -1))
        s2 = (torch.clamp(med, min=1e-12) * sigma_scale)[:, None, None]
    else:
        s2 = 2.0 * sigma * sigma
    w = torch.exp(-d2 / s2)
    if counts is not None:
        alive = (counts > 0).to(w.dtype)
        w = w * alive[:, :, None] * alive[:, None, :]
    return w


def _sym(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T) / 2, as jnp.linalg.eigh symmetrises its input."""
    return (a + a.transpose(-1, -2)) / 2


def smallest_eigvecs_subspace(l_sym: torch.Tensor, k: int, n_iter: int = 80,
                              oversample: int = 4, power_per_qr: int = 8) -> torch.Tensor:
    """(B, S, S) -> (B, S, k) eigenvectors of the k smallest eigenvalues by
    subspace iteration Q <- qr((2I - L)^p Q) from a cosine basis, then
    Rayleigh-Ritz."""
    b, s, _ = l_sym.shape
    m = min(s, k + oversample)
    dev = l_sym.device
    i = torch.arange(s, dtype=torch.float32, device=dev).reshape(-1, 1)
    j = torch.arange(m, dtype=torch.float32, device=dev).reshape(1, -1)
    q0 = torch.cos(math.pi * (i + 0.5) * j / s)
    q = torch.linalg.qr(q0).Q.expand(b, s, m)
    bmat = 2.0 * torch.eye(s, dtype=l_sym.dtype, device=dev) - l_sym
    for _ in range(max(1, n_iter // power_per_qr)):
        for _ in range(power_per_qr):
            q = bmat @ q
        q = torch.linalg.qr(q).Q
    t = q.transpose(1, 2) @ l_sym @ q  # (B, m, m)
    # in float64: on the card the batched small eigh is cuSOLVER's Jacobi,
    # which in float32 can stop unconverged (and raise) on the clustered
    # spectra of config4's pooled mosaics
    _, v = torch.linalg.eigh(_sym(t).double())
    return (q @ v.to(q.dtype))[:, :, :k]


def spectral_labels(w: torch.Tensor, n_regions: int, n_iter: int = 30,
                    eig_method: str = "auto") -> torch.Tensor:
    """(B, S, S) affinity -> (B, S) int32 region labels via the
    normalized-cut embedding; eig_method "auto" is the subspace iteration
    on the card and the dense eigh on the CPU."""
    eig_method = _eig_on(eig_method, w.device)
    s = w.shape[1]
    deg = w.sum(dim=2)
    d_isqrt = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))
    eye = torch.eye(s, dtype=w.dtype, device=w.device)
    l_sym = eye - d_isqrt[:, :, None] * w * d_isqrt[:, None, :]
    if eig_method == "eigh":
        emb = torch.linalg.eigh(_sym(l_sym)).eigenvectors[:, :, :n_regions]
    elif eig_method == "subspace":
        emb = smallest_eigvecs_subspace(l_sym, n_regions)
    else:
        raise ValueError(eig_method)
    # Ng-Jordan-Weiss row normalisation
    norm = torch.sqrt(torch.clamp((emb * emb).sum(dim=2, keepdim=True), min=1e-12))
    return kmeans_batched(emb / norm, n_regions, n_iter)


def ncut_regions(features: torch.Tensor, sp: torch.Tensor, n_sp: int, n_regions: int,
                 affinity_sigma: Optional[float] = None, eig_method: str = "auto",
                 sigma_scale: float = 1.0) -> torch.Tensor:
    """(B, D, N) features + (B, N) superpixel labels -> (B, S) int32 region
    ids."""
    f, counts = superpixel_means(features, sp, n_sp)
    aff = affinity_matrix(f, affinity_sigma, counts, sigma_scale)
    return spectral_labels(aff, n_regions, eig_method=eig_method)


def ncut_from_superpixels(features: torch.Tensor, sp: torch.Tensor, n_sp: int,
                          n_regions: int, affinity_sigma: Optional[float] = None,
                          eig_method: str = "auto", sigma_scale: float = 1.0) -> torch.Tensor:
    """One image: (H, W, D) features + (H, W) superpixel labels in [0, n_sp)
    -> (H, W) int32 region labels (the region ids broadcast by K15)."""
    features, sp = torch.as_tensor(features), torch.as_tensor(sp)
    h, w, d = features.shape
    sp = sp.reshape(1, h * w).to(torch.int32)
    feats = features.permute(2, 0, 1).reshape(1, d, h * w)
    regions = ncut_regions(feats, sp, n_sp, n_regions, affinity_sigma, eig_method, sigma_scale)
    return table_lookup(sp, regions).reshape(h, w)


def ncut_segment(features: torch.Tensor, lab: torch.Tensor, n_superpixels: int,
                 n_regions: int, ruler: float = 10.0, slic_iters: int = 10,
                 affinity_sigma: Optional[float] = None, eig_method: str = "auto",
                 sigma_scale: float = 1.0) -> torch.Tensor:
    """One image: (H, W, D) features + (H, W, 3) Lab -> (H, W) int32 region
    labels: ``slic``, ``enforce_connectivity_device``, then
    ``ncut_from_superpixels``."""
    features = torch.as_tensor(features)
    h, w, _ = features.shape
    sp = slic(lab, n_superpixels, ruler, slic_iters)
    gh, gw, _ = grid_shape(h, w, n_superpixels)
    sp = enforce_connectivity_device(sp[None], gh * gw)[0]
    return ncut_from_superpixels(features, sp, gh * gw, n_regions, affinity_sigma,
                                 eig_method, sigma_scale)


def superpixels(lab: torch.Tensor, g, slic_impl: str = "auto") -> Tuple[torch.Tensor, int]:
    """(B, H, W, 3) float32 Lab -> ((B, H, W) int32 4-connected superpixels,
    their count S): ``slic_batch`` under ``g``'s settings, then K14 (the
    reference's connectivity pass, which its graph stage runs after SLIC)."""
    _, h, w, _ = lab.shape
    gh, gw, _ = grid_shape(h, w, g.n_superpixels)
    with span("superpixels"):
        sp = slic_batch(lab, g.n_superpixels, g.slic_compactness, g.slic_iters, slic_impl)
        return enforce_connectivity_fused(sp, gh * gw), gh * gw


def graph_segment_batch(features: torch.Tensor, lab: torch.Tensor,
                        cfg: PipelineConfig) -> torch.Tensor:
    """(B, H, W, D) features + (B, H, W, 3) float32 Lab -> (B, H, W) int32
    region labels of the n-cut: ``superpixels`` (K11 or K13, then K14), the
    batched n-cut with the superpixel sums from K17, and the region ids
    broadcast to the pixels by K15.

    K17 reads the features channel-major: where ``features`` is the
    (B, H, W, D) view of a channel-major buffer (what ``assemble_features``
    returns), that buffer is read in place; any other layout is copied once.
    The min-cut is host-side (``mincut_segment``, through
    ``pipeline.segment_images``) and raises here, as the reference's."""
    g = cfg.graph
    if g.cut != "ncut":
        raise ValueError(f"cut={g.cut!r} is host-side (see mincut_segment); "
                         "use pipeline.segment_images")
    b, h, w, d = features.shape
    slic_impl, eig_method = resolve_graph_impls(g, cfg.dtype)
    sp, n_sp = superpixels(lab, g, slic_impl)
    with span("graph_cut"):
        sp = sp.reshape(b, h * w)
        feats = features.permute(0, 3, 1, 2).reshape(b, d, h * w)
        regions = ncut_regions(feats, sp, n_sp, g.n_regions, g.affinity_sigma, eig_method,
                               g.affinity_sigma_scale)
        return table_lookup(sp, regions).reshape(b, h, w)


# ---------------------------------------------------------------------------
# Min-cut variant (host; Felzenszwalb-style greedy merge over superpixels)
# ---------------------------------------------------------------------------


def _adjacency_pairs(sp: np.ndarray) -> np.ndarray:
    """(H, W) labels -> (E, 2) unique adjacent superpixel pairs (4-conn)."""
    a = np.stack([sp[:, :-1].reshape(-1), sp[:, 1:].reshape(-1)], 1)
    b = np.stack([sp[:-1, :].reshape(-1), sp[1:, :].reshape(-1)], 1)
    e = np.concatenate([a, b])
    e = e[e[:, 0] != e[:, 1]]
    e.sort(axis=1)
    return np.unique(e, axis=0)


def mincut_segment(features: np.ndarray, sp: np.ndarray, k: float = 300.0,
                   min_size: int = 10) -> np.ndarray:
    """Felzenszwalb merge on the superpixel graph (host).

    features: (H, W, D); sp: (H, W) superpixel labels. Edge weight = euclidean
    feature distance between superpixel means. Merge predicate: w <=
    min(Int(Ci) + k/|Ci|, Int(Cj) + k/|Cj|) (Int = max internal weight so
    far). A final pass absorbs regions smaller than min_size superpixels.
    Returns (H, W) int32 region labels (contiguous).
    """
    h, w, d = features.shape
    n_sp = int(sp.max()) + 1
    flat = features.reshape(-1, d).astype(np.float64)
    lab_flat = sp.reshape(-1)
    sums = np.zeros((n_sp, d))
    np.add.at(sums, lab_flat, flat)
    cnts = np.bincount(lab_flat, minlength=n_sp).astype(np.float64)
    means = sums / np.maximum(cnts, 1.0)[:, None]

    edges = _adjacency_pairs(sp)
    wts = np.linalg.norm(means[edges[:, 0]] - means[edges[:, 1]], axis=1)
    order = np.argsort(wts, kind="stable")

    parent = np.arange(n_sp)
    size = np.ones(n_sp)
    internal = np.zeros(n_sp)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for ei in order:
        a, b = find(edges[ei, 0]), find(edges[ei, 1])
        if a == b:
            continue
        wt = wts[ei]
        if wt <= min(internal[a] + k / size[a], internal[b] + k / size[b]):
            parent[b] = a
            size[a] += size[b]
            internal[a] = max(internal[a], internal[b], wt)

    # absorb small regions
    for ei in order:
        a, b = find(edges[ei, 0]), find(edges[ei, 1])
        if a != b and (size[a] < min_size or size[b] < min_size):
            parent[b] = a
            size[a] += size[b]

    roots = np.array([find(i) for i in range(n_sp)])
    _, regions = np.unique(roots, return_inverse=True)
    return regions[lab_flat].reshape(h, w).astype(np.int32)

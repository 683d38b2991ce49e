"""Per-image full-covariance GMM on the normalised (B, D, N) buffer
(counterpart of the JAX package's models/gmm_pallas.py), with kernel K8.

K8 ``em_pass`` (csrc/em_pass.cu) replaces ``_em_kernel``: one E+M step,
  y_j = P_j^T x - b_j,  maha_j = ||y_j||^2,  lp_j = const_j - maha_j / 2,
the first-index argmax labels and, unless ``moments=False``, log-sum-exp
responsibilities r_j, the per-image sum of the log-sum-exp and the
per-component moments sum r_j, sum r_j x and sum r_j x x^T. Arithmetic is
float32 in both storage dtypes: the TPU kernel's bf16x3 operand split made
up for a missing float32 dot on the TPU and is not carried over. The
kernel sums the moments in 4 x 8 register tiles of the extended scatter
(``tile_map``) over chunks of 640 pixels (``em_plan`` spreads the chunks
over one wave of blocks): in float32 over runs of 32 pixels and then over
at most 4 chunks, in float64 across those, the shares and the blocks,
rounded to float32 once, as ``em_pass_plain`` sums. Partials are per block
(float64) and reduced in block order, with no float atomics, so a run
repeats bit for bit: EM's basin depends on these sums over 30 iterations.
It takes D <= 128 feature rows, the reference's range (its K9 limit): up
to ``D_REGS`` = 40 rows (config2: 39) x sits in registers; wider rows (a
16-kernel bank gives 51) take a second, simple kernel in the same source
that walks chunks of 256 pixels and stages the components' triangles one
at a time.

The solver ``gmm_fused_t_xt`` mirrors the reference's sklearn semantics:
k-means init (K6 + K5), hard one-hot moments, ``n_iter`` EM iterations with
the per-image tol freeze, ``refine_iters`` full-resolution passes and a
labels-only pass. Each iteration factors the covariances with K9
(models/chol.py). The loop runs a fixed count with the freeze done by
``torch.where`` on the device, as the reference's ``fori_loop`` does, so the
host never waits on the card inside the solver. ``gmm_fused_t`` is its
entry on (B, N, D) features (the with-features path): the buffer is their
transpose, and the fit buffer their 2x2-pooled copy, transposed.

``_FUSED_PREP`` mirrors the reference's switch of the same name (off, as
there): when on, the solver carries EM's moments (counts, sums, scatter)
instead of sklearn's parameters, and every K8 pass takes its inputs from
one K10 launch (models/chol.py) instead of K9 and the plain parameter
glue; the reference's refine and labels passes went back to K9, which
computes the same inputs. The reference also required its TPU backend;
the port has no such condition, the switch alone decides.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.chol import (
    _moments_to_params,
    _params_to_kernel_inputs,
    precision_chol_params,
)
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels
from gabor_color_image_segmentation_tpu_torch.models.kmeans import pool2x2
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import K_MAX
from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import kmeans_fused_t_xt
from gabor_color_image_segmentation_tpu_torch.utils.trace import span

D_MAX = 128  # feature rows the card takes: the reference's K9 limit (its _LANES)
D_REGS = 40  # feature rows the first kernel holds in registers (config2: 39)
_FUSED_PREP = False  # the EM loop's moments -> K8 inputs step as one K10 launch


def _use_fused_prep() -> bool:
    return _FUSED_PREP


_EM_CHUNK = 640  # pixels a chunk of K8 (320 threads, two pixels each)
_EM_CHUNK_WIDE = 256  # pixels a chunk of K8's wide kernel (D > D_REGS), one a thread
_EM_TILE = (4, 8)  # rows and columns of one of K8's moments tiles


def em_chunk(d: int) -> int:
    """Pixels a chunk of the K8 kernel that takes d feature rows."""
    return _EM_CHUNK if d <= D_REGS else _EM_CHUNK_WIDE


def em_plan(b: int, n: int, n_sm: int, chunk: int = _EM_CHUNK):
    """K8's blocks: (chunks a block walks, blocks an image). Each image's
    ceil(n / chunk) chunks are split into runs of consecutive chunks so
    that the b images' blocks make about one wave over the card's n_sm SMs
    (one block an SM: each holds ~180 KB of shared memory), one block an
    image when the batch alone fills the card."""
    nchunks = -(-n // chunk)
    chunks = -(-nchunks // max(1, n_sm // b))
    return chunks, -(-nchunks // chunks)


def tile_map(d: int):
    """K8's moments tiles of one component: (first row, first column) of each
    4 x 8 tile that holds an entry (a >= c) of the lower triangle of the
    extended (d + 1) x (d + 1) scatter [x 1][x 1]^T, row-major."""
    ta, tc = _EM_TILE
    return [(a0, c0) for a0 in range(0, d + 1, ta) for c0 in range(0, a0 + ta, tc)]


def em_wide_stride(d: int) -> int:
    """Floats a pixel's extended column takes in the wide kernel's shared
    memory (csrc/em_pass.cu's wide_stride): every tile's rows a0 .. a0 + 3
    and columns c0 .. c0 + 7, rounded to 4 (mod 8) floats so that a
    thread's float4 reads of its own column hit distinct banks."""
    a0 = 4 * (d // 4)
    c0 = 8 * ((a0 + 3) // 8)
    return 4 * ((-(-max(a0 + 4, c0 + 8) // 4)) | 1)


@functools.lru_cache(maxsize=16)
def _tile_codes(d: int, k: int, device: str) -> torch.Tensor:
    """The kernel's tile list: component << 16 | first row << 8 | first
    column, component-major."""
    codes = [j << 16 | a0 << 8 | c0 for j in range(k) for a0, c0 in tile_map(d)]
    return torch.tensor(codes, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=16)
def _unpack_index(d: int, device: str):
    """Index of each output in one component's packed moments. The kernel
    extends x with a ones entry at index d and writes, per component, the
    tiles of ``tile_map(d)`` in order, entry (i, c) of a tile at 32 t + 8 i
    + c; the lower entry (a >= b) of the extended scatter sits in the tile
    of rows a // 4 * 4 and columns b // 8 * 8: (a < d, b < d) the scatter,
    (d, b < d) the sums, (d, d) the count. Returns (scatter index (d, d),
    sums index (d,), count index, packed entries per component)."""
    ta, tc = _EM_TILE
    tiles = tile_map(d)
    where = {t: i for i, t in enumerate(tiles)}

    def pos(a, c):  # a >= c
        return where[(a // ta * ta, c // tc * tc)] * ta * tc + a % ta * tc + c % tc

    scat = torch.tensor([[pos(max(i, j), min(i, j)) for j in range(d)] for i in range(d)])
    return (scat.to(device), torch.tensor([pos(d, c) for c in range(d)]).to(device),
            pos(d, d), len(tiles) * ta * tc)


def em_pass_plain(x, pt, bias, const, moments: bool = True):
    """Plain PyTorch version of K8 (same contract as em_pass). It computes in
    the parameters' dtype (float32; float64 parameters give a float64
    reference), but for the moments, which it sums in float64 and rounds
    once: summed in float32 over a full image (one cuBLAS product), a
    51-row buffer's moments were off by ~3e-6 of their summed magnitude and
    sklearn's E[x x^T] - mu mu^T went indefinite past reg_covar, where the
    kernel's blocked sums (~2e-7) did not."""
    xf = x.to(torch.promote_types(x.dtype, pt.dtype))
    y = torch.matmul(pt, xf[:, None]) - bias[..., None]  # (B, k, D, N)
    lp = const[..., None] - 0.5 * y.square().sum(dim=2)  # (B, k, N)
    del y
    labels = torch.argmax(lp, dim=1).to(torch.int32)  # first maximum
    if not moments:
        return labels
    m = lp.max(dim=1, keepdim=True).values
    ex = torch.exp(lp - m)
    se = ex.sum(dim=1, keepdim=True)
    resp = ex / se
    ll = (m + torch.log(se)).sum(dim=(1, 2))
    x64, r64 = xf.to(torch.float64), resp.to(torch.float64)
    sums = torch.bmm(r64, x64.transpose(1, 2))  # (B, k, D)
    scatter = torch.matmul(x64[:, None] * r64[:, :, None], x64.transpose(1, 2)[:, None])
    return (labels, ll, r64.sum(dim=2).to(xf.dtype), sums.to(xf.dtype),
            scatter.to(xf.dtype))


def em_pass(x, pt, bias, const, moments: bool = True):
    """One fused E+M pass over the normalised buffer.

    x: (B, D, N) float32 or bfloat16; pt: (B, k, D, D) float32 stacked P^T
    (lower; the kernel reads the lower triangle); bias: (B, k, D) float32
    P^T mu; const: (B, k) float32 log w + log det P - D/2 log 2 pi. Returns
    labels (B, N) int32 and, unless moments=False, (ll (B,) the sum of the
    per-pixel log-likelihoods, counts (B, k), sums (B, k, D), scatter
    (B, k, D, D)), float32."""
    _kernels.check(x.dim() == 3, f"x must be (B, D, N), got {tuple(x.shape)}")
    _kernels.storage_code(x.dtype)
    b, d, n = x.shape
    k = bias.shape[1] if bias.dim() == 3 else 0
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    for name, t, shape in (("pt", pt, (b, k, d, d)), ("bias", bias, (b, k, d)),
                           ("const", const, (b, k))):
        _kernels.check(tuple(t.shape) == shape and t.dtype == torch.float32,
                       f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if _kernels.use_plain(x, pt, bias, const):
        return em_pass_plain(x, pt, bias, const, moments)
    _kernels.check(d <= D_MAX and n >= 1,
                   f"the CUDA kernel takes D <= {D_MAX} (the reference's limit, its K9's) "
                   f"and N >= 1, got {d}, {n}")
    x, pt, bias, const = x.contiguous(), pt.contiguous(), bias.contiguous(), const.contiguous()
    labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
    dev = str(x.device)
    scat_idx, sums_idx, count_idx, tri = _unpack_index(d, dev)
    codes = _tile_codes(d, k, dev)
    width = k * tri + 1  # packed moments, then the log-likelihood
    chunks, nblk = em_plan(b, n, torch.cuda.get_device_properties(x.device).multi_processor_count,
                           em_chunk(d))
    partial = packed = None
    if moments:
        partial = torch.empty((b, nblk, width), dtype=torch.float64, device=x.device)
        packed = torch.empty((b, width), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "gcis_em_pass", x.data_ptr(), pt.data_ptr(), bias.data_ptr(), const.data_ptr(),
        codes.data_ptr(), labels.data_ptr(), None if partial is None else partial.data_ptr(),
        None if packed is None else packed.data_ptr(), b, d, n, k, chunks, codes.numel(),
        _kernels.storage_code(x.dtype), int(moments), outputs=(packed,) if moments else (),
    )
    em_pass.launches += 1
    if not moments:
        return labels
    per = packed[:, : k * tri].reshape(b, k, tri)
    return (labels, packed[:, k * tri], per[:, :, count_idx], per[:, :, sums_idx],
            per[:, :, scat_idx])


em_pass.launches = 0


def _init_moments(x, labels, k: int):
    """Hard one-hot moments of the k-means init: (counts, sums, scatter)."""
    xf = x.to(torch.float32)
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(torch.float32)
    onehot = onehot.transpose(1, 2)  # (B, k, N)
    sums = torch.bmm(onehot, xf.transpose(1, 2))
    scatter = torch.matmul(xf[:, None] * onehot[:, :, None], xf.transpose(1, 2)[:, None])
    return onehot.sum(dim=2), sums, scatter


def gmm_fused_t_xt(
    x: torch.Tensor,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    kmeans_iters: int = 10,
    tol: float = 0.0,
    fit_x: Optional[torch.Tensor] = None,
    refine_iters: int = 0,
) -> torch.Tensor:
    """GMM labels (B, N) int32 on the normalised buffer x (B, D, N).

    The mixture is fitted on ``fit_x`` (B, D, m) when given (the pooled fit
    grid, normalised with x's affine), else on x: k-means init (K6, K5),
    hard moments, ``n_iter`` EM iterations (K9, K8; K10, K8 with
    ``_FUSED_PREP``). tol > 0 applies sklearn's rule per image: an image
    whose mean log-likelihood moved by less than tol keeps its parameters
    (its moments, with ``_FUSED_PREP``) from then on. Then ``refine_iters``
    EM passes on x and one labels-only pass on x. The three stages are the
    spans ``gcis.gmm_init``, ``gcis.em_fit`` and ``gcis.em_refine``
    (utils/trace.py), with no host sync inside."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"fused EM supports k <= {K_MAX}, got {k}")
    fit = x if fit_x is None else fit_x
    b, _, m = fit.shape
    fused = _use_fused_prep()

    def inputs(state, rows):
        """K8's inputs from the loop's state, taken over ``rows`` pixels."""
        if fused:
            return precision_chol_params(*state, rows, reg_covar)
        return _params_to_kernel_inputs(*state)

    def em(state, rows, buf):
        _, ll, *moments = em_pass(buf, *inputs(state, rows))
        if fused:
            return tuple(moments), ll
        return _moments_to_params(*moments, buf.shape[2], reg_covar), ll

    with span("gmm_init"):
        init_labels, _ = kmeans_fused_t_xt(fit, k, kmeans_iters)
        # the state: EM's moments with the fused prep, else sklearn's parameters
        state = _init_moments(fit, init_labels, k)
        if not fused:
            state = _moments_to_params(*state, m, reg_covar)
    with span("em_fit"):
        prev_ll = torch.full((b,), float("-inf"), device=x.device)
        go = torch.full((b,), n_iter > 0, dtype=torch.bool, device=x.device)
        for _ in range(n_iter):
            new, ll = em(state, m, fit)
            ll = ll / m
            if tol == 0.0:
                state = new
                continue
            state = tuple(torch.where(go.reshape((b,) + (1,) * (p.dim() - 1)), p, q)
                          for p, q in zip(new, state))
            ll = torch.where(go, ll, prev_ll)
            go = go & ((ll - prev_ll).abs() >= tol)
            prev_ll = ll
    with span("em_refine"):
        rows = m
        for _ in range(refine_iters):
            state, _ = em(state, rows, x)
            rows = x.shape[2]
        return em_pass(x, *inputs(state, rows), moments=False)


def gmm_fused_t(
    x: torch.Tensor,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    kmeans_iters: int = 10,
    tol: float = 0.0,
    hw=None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> torch.Tensor:
    """(B, N, D) (or (N, D)) features -> (B, N) int32 labels through
    ``gmm_fused_t_xt``. The buffer is x's transpose in x's dtype (bf16
    stays bf16, anything else float32), no copy when x is the view of a
    channel-major buffer. With ``fit_pool`` (and ``hw``) the fit buffer is
    the features pooled ``gmm_fit_levels`` times by exact 2x2 means
    (``kmeans.pool2x2`` on the flat features), then transposed."""
    if x.dim() == 2:
        return gmm_fused_t(x[None], k, n_iter, reg_covar, kmeans_iters, tol, hw, fit_pool,
                           refine_iters)[0]
    dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    fit_x = None
    if fit_pool > 0:
        h, w = hw
        lv = gmm_fit_levels(h, w, fit_pool)[2]
        if lv > 0:
            fit_x = x
            for _ in range(lv):
                fit_x = pool2x2(fit_x, h, w)
                h, w = h // 2, w // 2
            fit_x = fit_x.to(dtype).transpose(1, 2).contiguous()
    return gmm_fused_t_xt(x.to(dtype).transpose(1, 2).contiguous(), k, n_iter, reg_covar,
                          kmeans_iters, tol, fit_x, refine_iters)

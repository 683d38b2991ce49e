"""PyTorch port: the with-features path's k-means solver
(``models/kmeans.py::kmeans_batch`` and the transposed solver
``models/kmeans_fused.py::kmeans_fused_t`` it routes to) against the JAX
package's.

The port resolves the reference's fused-solver gate with the card in place
of the TPU (k <= 8 and 4,096 <= N <= 10,000,000, by k and N alone), so on
the CPU it walks the card's route with K5's and K6's plain versions; the
JAX package off the TPU takes its XLA solvers. Both are held against the
port: ``kmeans_batch`` against JAX's ``kmeans_batch``, and the multigrid
branch also against JAX's ``kmeans_fused_t`` (its Pallas kernels in
interpret mode).

Inputs: the port's config0 features of synthetic mosaics (seeds 104+).
Bounds after Hungarian alignment: labels >= 0.999 (float32) / >= 0.99
(bfloat16, on images whose JAX bf16 and f32 labels agree >= 0.99 first)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import kmeans as tkm
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

jkm = importlib.import_module("gabor_color_image_segmentation_tpu.models.kmeans")
jkp = importlib.import_module("gabor_color_image_segmentation_tpu.models.kmeans_pallas")

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HW = (64, 128)  # N = 8,192: the fused route, and 4,096 pixels at subsample 2

# kmeans_batch's options beyond (k, n_iter) -> expected route ("fused" or
# "plain"), on the HW frames unless noted
CASES = {
    "plain": (dict(), "fused"),
    "multigrid_l1": (dict(hw=HW, coarse_iters=6, refine_iters=2), "fused"),
    "multigrid_l2_mid": (dict(hw=HW, coarse_iters=6, refine_iters=2, coarse_levels=2,
                              mid_iters=2), "fused"),
    "subsample_2": (dict(subsample=2), "fused"),
    "init_stride_2": (dict(init_stride=2), "fused"),
    "k_10": (dict(k=10), "plain"),
    "small_frame": (dict(hw=(48, 64), coarse_iters=6, refine_iters=2), "plain"),
}


def _features(hw, seed=104):
    cfg = preset("config0").replace(batch_size=2)
    rgb = np.stack([synthetic_mosaic(h=hw[0], w=hw[1], n_regions=5, seed=seed + i)[0]
                    for i in range(2)])
    feats = pipeline.compute_features(torch.from_numpy(rgb), cfg, make_bank(cfg.bank))
    return feats.reshape(2, hw[0] * hw[1], -1).contiguous().numpy()


@pytest.fixture(scope="module")
def features():
    cache = {}

    def get(hw):
        if hw not in cache:
            cache[hw] = _features(hw)
        return cache[hw]

    return get


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


def _split(opts):
    opts = dict(opts)
    k = opts.pop("k", 5)
    hw = opts.get("hw", HW)
    if "coarse_iters" not in opts:
        opts.pop("hw", None)
    return k, hw, opts


@pytest.fixture
def route(monkeypatch):
    """The solver kmeans_batch reached on its last call: "fused" when it went
    through kmeans_fused.kmeans_fused_t, else "plain"."""
    seen = []
    real = kf.kmeans_fused_t

    def spy(*args, **kw):
        seen.append("fused")
        return real(*args, **kw)

    monkeypatch.setattr(kf, "kmeans_fused_t", spy)
    return seen


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kmeans_batch_matches_jax(features, route, dtype, case):
    opts, want_route = CASES[case]
    k, hw, opts = _split(opts)
    jdt, tdt = DTYPES[dtype]
    x = features(hw)
    ref, ref_c = jkm.kmeans_batch(jnp.asarray(x), k, 10, jdt, **opts)
    ref = np.asarray(ref)
    if dtype == "bfloat16":
        ref32 = np.asarray(jkm.kmeans_batch(jnp.asarray(x), k, 10, jnp.float32, **opts)[0])
        stable = _agreement(ref, ref32)
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, centers = tkm.kmeans_batch(torch.from_numpy(x), k, 10, tdt, **opts)
    assert route == (["fused"] if want_route == "fused" else [])
    assert labels.dtype == torch.int32 and tuple(labels.shape) == x.shape[:2]
    assert centers.dtype == torch.float32 and tuple(centers.shape) == (2, k, x.shape[2])
    agree = _agreement(labels.numpy(), ref)
    assert min(agree) >= FLOOR[dtype], agree


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multigrid_matches_jax_fused_solver(features, dtype, levels):
    """kmeans_fused_t's multigrid branch (pooled seeds and passes, mid
    passes at level 2) against the JAX package's, its kernels in interpret
    mode."""
    jdt, tdt = DTYPES[dtype]
    x = features(HW)
    args = (5, 10)
    sched = (1, HW, 6, 2, levels, 2 if levels > 1 else 0)
    ref, ref_c = jkp.kmeans_fused_t(jnp.asarray(x), *args, jdt, *sched)
    labels, centers = kf.kmeans_fused_t(torch.from_numpy(x), *args, tdt, *sched)
    agree = _agreement(labels.numpy(), np.asarray(ref))
    assert min(agree) >= FLOOR[dtype], agree
    if dtype == "float32" and min(agree) == 1.0:
        assert np.abs(centers.numpy() - np.asarray(ref_c)).max() <= 1e-4


def test_fused_gate_is_the_references(monkeypatch):
    """fused_solver_ready at the edges of k and N equals the reference's
    fused_solver_eligible on a TPU backend (patched here; the JAX package
    is unchanged), for the solver's and the pipeline's pixel bounds."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert (tkm.SOLVER_N_MAX, tkm.PIPELINE_N_MAX) == (jkm.SOLVER_N_MAX, jkm.PIPELINE_N_MAX)
    for n_max in (tkm.SOLVER_N_MAX, tkm.PIPELINE_N_MAX):
        for k in (1, 8, 9):
            for n in (tkm.FUSED_N_MIN - 1, tkm.FUSED_N_MIN, n_max, n_max + 1):
                assert tkm.fused_solver_ready(k, n, n_max) == jkp.fused_solver_eligible(
                    k, n, n_max), (k, n, n_max)


@pytest.mark.parametrize("hw", [(63, 65), (64, 64)])
def test_kmeans_batch_route_at_the_pixel_edge(route, hw):
    """4,095 pixels take the plain solver, 4,096 the transposed one."""
    x = torch.from_numpy(_features(hw, seed=110))
    labels, _ = tkm.kmeans_batch(x, 5, 4)
    assert route == ([] if hw[0] * hw[1] < tkm.FUSED_N_MIN else ["fused"])
    assert 0 <= int(labels.min()) and int(labels.max()) < 5


def test_wrapper_swaps_reach_the_solvers(features, monkeypatch):
    """kmeans_batch and gmm_fused_t call K5 and K6 through the module
    attributes kmeans_fused.lloyd_t_pass / maximin_t_pass, the ones
    chip_smoke.py's all-plain comparison swaps."""
    from gabor_color_image_segmentation_tpu_torch.models.gmm_fused import gmm_fused_t

    calls = {"lloyd_t_pass": 0, "maximin_t_pass": 0}
    for name in calls:
        real = getattr(kf, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(kf, name, spy)
    x = torch.from_numpy(features(HW))
    tkm.kmeans_batch(x, 5, 3, hw=HW, coarse_iters=2, refine_iters=1, coarse_levels=2,
                     mid_iters=1)
    assert calls == {"lloyd_t_pass": 2 + 1 + 1 + 1, "maximin_t_pass": 5}
    for name in calls:
        calls[name] = 0
    gmm_fused_t(x, 5, 2, hw=HW, fit_pool=1)
    assert calls["maximin_t_pass"] == 5 and calls["lloyd_t_pass"] == 10 + 1


def test_kmeans_image_and_fit_assign(features):
    x = torch.from_numpy(features(HW))
    labels, centers = tkm.kmeans_image(x[0].reshape(*HW, -1), 5, 10)
    want, want_c = tkm.kmeans(x[0], 5, 10)
    assert torch.equal(labels, want.reshape(HW)) and torch.equal(centers, want_c)
    ref, _ = jkm.kmeans_fit_assign(jnp.asarray(x[0].numpy()), 5, 10, jnp.float32, 3)
    got, _ = tkm.kmeans_fit_assign(x[0], 5, 10, torch.float32, 3)
    assert _agreement(got[None].numpy(), np.asarray(ref)[None])[0] >= FLOOR["float32"]


def test_labels_only_init_stride_takes_the_strided_transposed_route(monkeypatch):
    """Labels only, k-means with init_stride > 1 on a frame of the
    transposed range runs the reference's transposed route off its CHW
    solver: the normalised buffer, maximin_init on every second pixel and
    K5."""
    calls = []
    real = kf.maximin_init
    monkeypatch.setattr(kf, "maximin_init",
                        lambda x, k, s: calls.append((tuple(x.shape), s)) or real(x, k, s))
    cfg = preset("config0")
    cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, init_stride=2))
    assert pipeline._can_segment_transposed(cfg, 64, 64)
    rgb = synthetic_mosaic(h=64, w=64, n_regions=4, seed=116)[0][None]
    labels, _ = pipeline.segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert calls == [((1, 4096, 39), 2)]
    assert 0 <= int(labels.min()) and int(labels.max()) < 5

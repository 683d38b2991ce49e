"""Frozen dataclass configs and the five acceptance presets (the port's own
copy of the JAX package's config.py, field for field and default for
default; the tests hold the two equal).

The port keeps a copy rather than importing the reference module: importing
any module of the JAX package runs that package's ``__init__.py``. Every
function of the port reads these configs by field name, so it also accepts
the JAX package's config objects.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class BankConfig:
    """Gabor filter bank: scales x orientations x frequencies.

    ``frequencies`` None derives one frequency per scale, f = 0.56 / sigma;
    kernel half-size = ceil(truncate * sigma), capped by ``max_ksize``;
    energy smoothing sigma = smoothing * sigma, radius
    ceil(smooth_truncate * smoothing sigma)."""

    scales: Tuple[float, ...] = (2.0, 4.0, 8.0)
    orientations: int = 4
    frequencies: Optional[Tuple[float, ...]] = None
    gamma: float = 1.0
    psi: float = 0.0
    truncate: float = 3.0
    max_ksize: int = 31
    smoothing: float = 1.0
    smooth_truncate: float = 3.0

    @property
    def n_frequencies(self) -> int:
        return 1 if self.frequencies is None else len(self.frequencies)

    @property
    def n_kernels(self) -> int:
        return len(self.scales) * self.orientations * self.n_frequencies

    def kernel_params(self) -> list[tuple[float, float, float, int]]:
        """Flat list of (sigma, theta, lambda, ksize): scale-major, then
        orientation, then frequency (the feature-layout contract)."""
        params = []
        for sigma in self.scales:
            for o in range(self.orientations):
                theta = math.pi * o / self.orientations
                freqs = (0.56 / sigma,) if self.frequencies is None else self.frequencies
                for f in freqs:
                    params.append((sigma, theta, 1.0 / f, self.ksize_for(sigma)))
        return params

    def ksize_for(self, sigma: float) -> int:
        k = 2 * int(math.ceil(self.truncate * float(sigma))) + 1
        return min(k, self.max_ksize) | 1

    def smooth_sigma_for(self, sigma: float) -> float:
        return self.smoothing * float(sigma)

    def smooth_radius_for(self, sigma: float) -> int:
        return int(math.ceil(self.smooth_truncate * self.smooth_sigma_for(sigma)))

    @property
    def max_halo(self) -> int:
        return max(ksize // 2 + self.smooth_radius_for(sigma)
                   for sigma, _, _, ksize in self.kernel_params())

    @property
    def max_conv_radius(self) -> int:
        return max(ksize // 2 for _, _, _, ksize in self.kernel_params())

    @property
    def max_smooth_radius(self) -> int:
        return max(self.smooth_radius_for(sigma) for sigma, _, _, _ in self.kernel_params())


@dataclass(frozen=True)
class ClusterConfig:
    """Pixel-clustering stage: k-means (with the multigrid schedule) or the
    per-image full-covariance GMM. See the JAX package's config.py for the
    measurements behind each default."""

    method: str = "kmeans"  # "kmeans" | "gmm"
    k: int = 5
    n_iter: int = 25  # Lloyd iterations / EM iterations
    coarse_iters: int = 0
    refine_iters: int = 10
    mid_iters: int = 0
    coarse_levels: int = 1
    subsample: int = 1
    init_stride: int = 1
    color_weight: float = 1.0
    normalize: bool = True
    feature_set: str = "full"  # "full" | "color" | "texture"
    cue_weight: str = "static"  # "static" | "coherence"
    coherence_pow: float = 1.0
    gmm_reg_covar: float = 1e-4
    gmm_tol: float = 0.0  # EM stops when the mean log-likelihood moves < tol
    gmm_fit_pool: int = 0  # fit on the grid 2x2-mean-pooled this many times
    gmm_refine_iters: int = 0  # full-resolution EM passes after the fit
    seed: int = 0


@dataclass(frozen=True)
class GraphConfig:
    """Superpixel + graph-cut stage."""

    enabled: bool = False
    n_superpixels: int = 400
    slic_compactness: float = 10.0
    slic_iters: int = 10
    pool: int = 0
    cut: str = "ncut"  # "ncut" | "mincut"
    n_regions: int = 5
    affinity_sigma: Optional[float] = None
    affinity_sigma_scale: float = 1.0
    eig_method: str = "auto"  # "auto" | "eigh" | "subspace"
    slic_impl: str = "auto"  # "auto" | "fused" | "xla"
    adjacency_only: bool = False
    mincut_k: float = 300.0
    mincut_min_size: int = 10


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end run configuration."""

    name: str = "custom"
    bank: BankConfig = BankConfig()
    cluster: ClusterConfig = ClusterConfig()
    graph: GraphConfig = GraphConfig()
    color_space: str = "lab"  # "lab" | "rgb"
    image_hw: Tuple[int, int] = (321, 481)
    batch_size: int = 1
    dtype: str = "float32"  # "float32" | "bfloat16"
    feature_impl: str = "auto"  # "auto" | "pallas" | "modulated" | "direct"
    mesh_shape: Tuple[int, ...] = (1,)
    tile_hw: Optional[Tuple[int, int]] = None

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


_SMALL_BANK = BankConfig(scales=(2.0, 4.0, 8.0), orientations=4, frequencies=None)
_FULL_BANK = BankConfig(scales=(1.5, 2.5, 4.0, 6.0, 8.0), orientations=8,
                        frequencies=(0.10, 0.20))

PRESETS: dict[str, PipelineConfig] = {
    # one 321x481 image, 12-kernel bank, k-means k=5
    "config0": PipelineConfig(
        name="config0", bank=_SMALL_BANK,
        cluster=ClusterConfig(method="kmeans", k=5, cue_weight="coherence",
                              coherence_pow=4.0),
        graph=GraphConfig(enabled=False), batch_size=1, feature_impl="auto",
    ),
    # 80-kernel bank over Lab, batch 16, multigrid k-means
    "config1": PipelineConfig(
        name="config1", bank=_FULL_BANK,
        cluster=ClusterConfig(method="kmeans", k=5, coarse_iters=15, refine_iters=1,
                              coarse_levels=2, mid_iters=3, cue_weight="coherence",
                              coherence_pow=4.0),
        graph=GraphConfig(enabled=False), batch_size=16,
    ),
    # per-image GMM fitted on the 4x4 grid, one full-resolution refine pass
    "config2": PipelineConfig(
        name="config2", bank=_SMALL_BANK,
        cluster=ClusterConfig(method="gmm", k=5, n_iter=30, gmm_tol=1e-3,
                              gmm_fit_pool=2, gmm_refine_iters=1),
        graph=GraphConfig(enabled=False), batch_size=8,
    ),
    # superpixel affinity graph + spectral normalized cut
    "config3": PipelineConfig(
        name="config3", bank=_SMALL_BANK, cluster=ClusterConfig(method="kmeans", k=5),
        graph=GraphConfig(enabled=True, n_superpixels=900, slic_compactness=5.0,
                          cut="ncut", n_regions=8, affinity_sigma_scale=0.1),
        batch_size=8,
    ),
    # tiled 4K frames, data parallel over 8 devices, cut chain on the 4x4 grid
    "config4": PipelineConfig(
        name="config4", bank=_SMALL_BANK, cluster=ClusterConfig(method="kmeans", k=5),
        graph=GraphConfig(enabled=True, pool=2), image_hw=(2160, 3840),
        batch_size=8, mesh_shape=(8,), tile_hw=(432, 768),
    ),
}


def preset(name: str) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]

#!/usr/bin/env python3
"""Which float32 modulated route is nearer the exact value: the port's or
the JAX package's? config3's graph stage takes the modulated route in
float32 (``feature_impl="auto"``, models/pipeline.py), and its features
part from the reference's by ~1.5e-4 of the peak at the published 321x481
frame, where K1's route parts by ~2e-6.

For each seed (bench mosaics, 5 regions) this evaluates the modulated
energies of ``ops/modulated.py`` in float64 (the same arithmetic: the
float32 taps, frequencies and DC means as parameters, every product and
sum in float64) and measures against it, on the same float32 Lab:

- the port's float32 energies (``gabor_energies_mod``);
- the reference's float32 energies, under one jit and eagerly (op by op),
  and the spread between those two;

each as max |e - e64| over the peak energy and over each channel's
standard deviation (what the standardisation divides by). Then the
features (``assemble_features``): float64 standardisation of the float64
energies against each package's float32 features on its own energies,
and each package's float32 standardisation handed the float64 energies
rounded to float32, which splits the feature error into its energies part
and its standardisation part. Last, each package's whole with-features
path (``segment_batch``, its own colour transform) against the float64
features of the float64 colour transform.

    JAX_PLATFORMS=cpu python3 experiments/torch_modulated_f64.py [--seeds 100,101] [--preset config3]

~2 min on 8 CPU cores at batch 2 (most of it the reference's jit of the
unrolled tap loops).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gabor_color_image_segmentation_tpu.config import preset as jax_preset  # noqa: E402
from gabor_color_image_segmentation_tpu.models.pipeline import (  # noqa: E402
    segment_batch as jax_segment_batch,
)
from gabor_color_image_segmentation_tpu.ops import modulated as jmod  # noqa: E402
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu.ops.features import (  # noqa: E402
    assemble_features as jax_assemble,
)
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (  # noqa: E402
    segment_batch,
)
from gabor_color_image_segmentation_tpu_torch.ops import color as tcolor  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.features import (  # noqa: E402
    assemble_features,
)
from gabor_color_image_segmentation_tpu_torch.ops.fused import _reflect_pad  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.modulated import (  # noqa: E402
    _dc_mu,
    _envelope_taps,
    gabor_energies_mod,
    group_frequencies,
)

F64 = torch.float64


def _sep_1d_f64(x, taps, axis):
    """ops/modulated.py's _sep_1d with every product and sum in float64."""
    k = taps.shape[0]
    n = x.shape[axis] - k + 1
    acc = taps[0] * x.narrow(axis, 0, n)
    for t in range(1, k):
        acc = acc + taps[t] * x.narrow(axis, t, n)
    return acc


def _pad(x, rh, rw):
    if rh:
        x = _reflect_pad(x, rh, 1)
    if rw:
        x = _reflect_pad(x, rw, 2)
    return x


def energies_f64(img: torch.Tensor, bank) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, N * C) float64 modulated energies: the
    port's modulated_group_magnitudes and smooth_group_magnitudes with the
    float32 parameters (taps, frequencies, DC means) and float64 arithmetic."""
    parts = []
    x = img.to(F64)
    b, h, w, c = x.shape
    for g in bank.groups:
        n = len(g.kernel_indices)
        p = g.ksize // 2
        env = torch.from_numpy(_envelope_taps(g.sigma, p).astype(np.float64))
        freqs = group_frequencies(g, bank).astype(np.float32).astype(np.float64)
        mus = torch.from_numpy(_dc_mu(g, bank).astype(np.float64))
        xpad = _pad(x, p, p)
        yy = torch.arange(-p, h + p, dtype=F64).reshape(-1, 1)
        xx = torch.arange(-p, w + p, dtype=F64).reshape(1, -1)
        wx = torch.from_numpy(freqs[:, 0]).reshape(1, 1, -1)
        wy = torch.from_numpy(freqs[:, 1]).reshape(1, 1, -1)
        phase_q = wx * xx[..., None] + wy * yy[..., None]
        mod = torch.stack([torch.cos(phase_q), -torch.sin(phase_q)], dim=-1)
        m = (xpad[..., None, None] * mod[None, :, :, None]).reshape(
            b, h + 2 * p, w + 2 * p, c * 2 * n)
        gg = _sep_1d_f64(_sep_1d_f64(m, env, 1), env, 2).reshape(b, h, w, c, n, 2)
        del m
        ones = torch.ones((g.ksize,), dtype=F64)
        box = _sep_1d_f64(_sep_1d_f64(xpad, ones, 1), ones, 2)
        phase_p = phase_q[p:p + h, p:p + w]
        cos_p = torch.cos(phase_p)[None, :, :, None, :]
        sin_p = torch.sin(phase_p)[None, :, :, None, :]
        re = cos_p * gg[..., 0] - sin_p * gg[..., 1]
        im = sin_p * gg[..., 0] + cos_p * gg[..., 1]
        re = re - mus.reshape(1, 1, 1, 1, -1) * box[..., None]
        mag = torch.sqrt(re * re + im * im).permute(0, 1, 2, 4, 3).reshape(b, h, w, n * c)
        r = g.smooth_radius
        st = torch.from_numpy(np.asarray(g.smooth_taps, np.float64))
        s = _sep_1d_f64(_pad(mag, r, 0), st, 1)
        parts.append(_sep_1d_f64(_pad(s, 0, r), st, 2))
    return torch.cat(parts, dim=-1)


def features_f64(energies: torch.Tensor, color: torch.Tensor, cluster, eps=1e-6):
    """assemble_features' standardisation in float64 (two-pass variance):
    (B, H, W, E) and (B, H, W, 3) -> (B, H, W, E + 3) float64."""
    e = energies.shape[-1]
    f = torch.cat([energies.to(F64), color.to(F64)], dim=-1)
    mean = f.mean(dim=(1, 2), keepdim=True)
    std = (f - mean).square().mean(dim=(1, 2), keepdim=True).sqrt()
    cw = cluster.color_weight * np.sqrt(e / 3.0)
    scale = torch.cat([torch.ones(e, dtype=F64), torch.full((3,), cw, dtype=F64)])
    return (f - mean) / (std + eps) * scale


def lab_f64(rgb_u8: np.ndarray) -> torch.Tensor:
    """ops/color.py's transform in float64."""
    rgb = torch.from_numpy(rgb_u8).to(F64) / 255.0
    lin = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    m, wht, d = tcolor._RGB2XYZ, tcolor._WHITE, tcolor._DELTA
    fs = []
    for i in range(3):
        t = (m[i][0] * lin[..., 0] + m[i][1] * lin[..., 1] + m[i][2] * lin[..., 2]) / wht[i]
        fs.append(torch.where(t > d**3, t.clamp(min=d**3) ** (1.0 / 3.0),
                              t / (3.0 * d**2) + 4.0 / 29.0))
    fx, fy, fz = fs
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def rel_peak(a, exact) -> float:
    a = np.asarray(a, np.float64)
    exact = np.asarray(exact, np.float64)
    return float(np.abs(a - exact).max() / np.abs(exact).max())


def rel_std(a, exact) -> float:
    """max over images and channels of max |a - exact| / the channel's std."""
    a = np.asarray(a, np.float64)
    exact = np.asarray(exact, np.float64)
    err = np.abs(a - exact).max(axis=(1, 2))
    return float((err / exact.std(axis=(1, 2))).max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="100,101")
    ap.add_argument("--preset", default="config3")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    torch.set_num_threads(8)
    cfg = preset(args.preset).replace(batch_size=len(seeds), dtype="float32")
    jcfg = jax_preset(args.preset).replace(batch_size=len(seeds), dtype="float32",
                                           feature_impl="auto")
    h, w = cfg.image_hw
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=s)[0] for s in seeds])
    bank, jbank = make_bank(cfg.bank), jax_make_bank(jcfg.bank)
    lab = tcolor.rgb_to_lab(torch.from_numpy(rgb))  # the port's float32 Lab, for all
    lab_np = lab.numpy()

    e64 = energies_f64(lab, bank)
    e_port = gabor_energies_mod(lab, bank, torch.float32)
    jit_fn = jax.jit(lambda x: jmod.gabor_energies_mod(x, jbank, jnp.float32))
    e_jit = np.asarray(jit_fn(jnp.asarray(lab_np)))
    with jax.disable_jit():
        e_eager = np.asarray(jmod.gabor_energies_mod(jnp.asarray(lab_np), jbank, jnp.float32))
    print(f"# {args.preset} f32, seeds {seeds}, {h}x{w}, E = {e64.shape[-1]}")
    print("energies on the same float32 Lab, against float64: "
          "max|d| / peak, max|d| / channel std")
    for name, e in (("port", e_port.numpy()), ("reference jit", e_jit),
                    ("reference eager", e_eager)):
        print(f"  {name:16s} {rel_peak(e, e64):.3e}  {rel_std(e, e64):.3e}")
    print(f"  spread: reference jit vs eager {rel_peak(e_jit, e_eager):.3e} "
          f"{rel_std(e_jit, e_eager):.3e}; port vs reference jit "
          f"{rel_peak(e_port.numpy(), e_jit):.3e} {rel_std(e_port.numpy(), e_jit):.3e}")
    worst = np.abs(e_port.numpy() - e64.numpy()).max(axis=(0, 1, 2))
    std = e64.numpy().std(axis=(1, 2)).min(axis=0)
    mean = e64.numpy().mean(axis=(1, 2)).max(axis=0)
    top = np.argsort(-(worst / std))[:4]
    print("  the port's worst channels (index: max|d|, std, mean):",
          ", ".join(f"{i}: {worst[i]:.2e}, {std[i]:.2e}, {mean[i]:.2e}" for i in top))

    cl = cfg.cluster
    f64 = features_f64(e64, lab, cl).numpy()
    e64_32 = e64.to(torch.float32)

    def port_feats(e):
        return assemble_features(torch.as_tensor(e).permute(0, 3, 1, 2), lab, cl).numpy()

    def ref_feats(e):
        return np.asarray(jax_assemble(jnp.asarray(np.asarray(e)), jnp.asarray(lab_np), cl))

    print("features against float64 energies and standardisation: max|d| / peak")
    rows = (("port, its energies", port_feats(e_port)),
            ("reference, its jit energies", ref_feats(e_jit)),
            ("reference, its eager energies", ref_feats(e_eager)),
            ("port, float64 energies rounded", port_feats(e64_32)),
            ("reference, float64 energies rounded", ref_feats(e64_32.numpy())))
    for name, f in rows:
        print(f"  {name:36s} {rel_peak(f, f64):.3e}")
    print(f"  port vs reference (each its own energies) "
          f"{rel_peak(rows[0][1], rows[1][1]):.3e}; reference jit vs eager "
          f"{rel_peak(rows[1][1], rows[2][1]):.3e}")

    # each package's whole with-features path, its own colour transform
    _, f_port = segment_batch(rgb, cfg, device="cpu")
    _, f_ref = jax_segment_batch(rgb, jcfg, jbank)
    f64_e2e = features_f64(energies_f64(lab_f64(rgb), bank), lab_f64(rgb), cl).numpy()
    print("segment_batch features against the float64 path (float64 colour too): "
          "max|d| / peak")
    print(f"  port {rel_peak(f_port.numpy(), f64_e2e):.3e}  reference "
          f"{rel_peak(np.asarray(f_ref), f64_e2e):.3e}  port vs reference "
          f"{rel_peak(f_port.numpy(), np.asarray(f_ref)):.3e}")


if __name__ == "__main__":
    main()

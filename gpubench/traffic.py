"""The frames a cell sends, made from ``--seed``: texture mosaics, the JAX
bench's own traffic (its ``data/synthetic.py::synthetic_mosaic``: Voronoi
regions, each a base colour plus an oriented sinusoid, Gaussian noise),
drawn here on the device in float64 and handed to the program as host
uint8 batches.

A traffic file sets the frame size, the batch, the pool of distinct frames
(cycled, ``pool`` a multiple of ``batch``), the mosaic's parameters and how
the harness drives the cell (a closed loop of one client; warm-up batches,
batches checked against the reference, traced batches, device-resident
iterations). Every seed gives the same sizes and the same schedule; only
the pictures differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KEYS = ("frame_hw", "batch", "pool", "n_regions", "texture_strength", "noise", "loop",
        "clients", "warmup_batches", "check_batches", "trace_batches", "resident_iters")


def check(traffic: dict) -> None:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise KeyError(f"traffic file lacks {missing}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the generator drives a closed loop of one client")
    if traffic["pool"] % traffic["batch"]:
        raise ValueError("pool must be a multiple of batch")
    if not 1 <= traffic["check_batches"] <= traffic["pool"] // traffic["batch"]:
        raise ValueError("check_batches must be 1 .. pool / batch")


def _hsv_to_rgb(h: float, s: float, v: float):
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


def frame_params(seed: int, index: int, h: int, w: int, n: int) -> dict:
    """Frame ``index``'s regions, drawn as synthetic_mosaic draws them:
    sites, shuffled hues, then a texture angle, frequency and phase a
    region."""
    rng = np.random.default_rng([index, seed64(seed)])
    sites = np.stack([rng.uniform(0, h, n), rng.uniform(0, w, n)], axis=1)
    hues = np.linspace(0.0, 1.0, n, endpoint=False)
    rng.shuffle(hues)
    base, theta, freq, phase = [], [], [], []
    for r in range(n):
        base.append(_hsv_to_rgb(hues[r], 0.55, 0.75))
        theta.append(rng.uniform(0, np.pi))
        freq.append(rng.uniform(0.06, 0.22))
        phase.append(rng.uniform(0, 2 * np.pi))
    return {"sites": sites, "base": np.asarray(base), "theta": np.asarray(theta),
            "freq": np.asarray(freq), "phase": np.asarray(phase)}


def make_pool(seed: int, traffic: dict, device) -> np.ndarray:
    """(pool, H, W, 3) uint8 host frames; the noise from one generator on
    ``device`` seeded by ``seed``, frame by frame."""
    h, w = traffic["frame_hw"]
    n = traffic["n_regions"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed64(seed))
    f64 = dict(dtype=torch.float64, device=dev)
    yy = torch.arange(h, **f64)[:, None].expand(h, w)
    xx = torch.arange(w, **f64)[None, :].expand(h, w)
    out = torch.empty((traffic["pool"], h, w, 3), dtype=torch.uint8, device=dev)
    for i in range(traffic["pool"]):
        p = {k: torch.as_tensor(v, **f64) for k, v in frame_params(seed, i, h, w, n).items()}
        d = (yy[..., None] - p["sites"][:, 0]) ** 2 + (xx[..., None] - p["sites"][:, 1]) ** 2
        gt = torch.argmin(d, dim=-1)  # (H, W) region ids
        arg = (2 * math.pi * p["freq"] * (xx[..., None] * torch.cos(p["theta"])
                                          + yy[..., None] * torch.sin(p["theta"])) + p["phase"])
        tex = torch.gather(torch.sin(arg), 2, gt[..., None])  # (H, W, 1)
        img = p["base"][gt] + traffic["texture_strength"] * tex
        img = img + traffic["noise"] * torch.randn((h, w, 3), generator=gen, **f64)
        out[i] = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return out.cpu().numpy()


def batches(pool: np.ndarray, batch: int) -> list:
    """The pool as pool / batch contiguous host batches, sent in turn."""
    return [np.ascontiguousarray(pool[i:i + batch]) for i in range(0, len(pool), batch)]

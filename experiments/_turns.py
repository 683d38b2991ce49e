"""Helpers the torch_k*.py experiments share: CUDA-event timing, the H100's
bound on a kernel's work, the card's name and power limit, building a copy
of a kernel's source (another commit's, or one with a phase patched out)
into a shared library of its own, an empty kernel (the one-launch floor)
and a (B, D, N) buffer of blobs.

Imported by the scripts in this directory, run as
``python3 experiments/<script>.py``."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM HBM3
F32_FLOP_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores
CYCLES_PER_MS = 2.0e6


def cuda_ms(fn, inner=1, hold_ms=0.0, reps=5):
    """Median of ``reps`` CUDA-event readings of ``inner`` back-to-back calls
    (ms a call), each behind a sleep kernel of ``hold_ms`` so that the host
    queues the calls before the first runs."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold_ms:
            torch.cuda._sleep(int(hold_ms * CYCLES_PER_MS))
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's rate
    and the float32 operations over the CUDA cores' peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOP_PER_MS
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(sources: list, names: list, entries: dict) -> list:
    """Each source built into a shared library of its own (one nvcc each,
    all started together) under ``_build/``, its entries bound."""
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._find_nvcc()
    procs, outs = [], []
    for text, name in zip(sources, names):
        cu = _kernels.BUILD_DIR / f"{name}.cu"
        cu.write_text(text)
        out = cu.with_suffix(".so")
        procs.append(subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, "-shared", str(cu), "-o",
                                       str(out)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    libs = []
    for proc, out in zip(procs, outs):
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"build of {out.name} failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in entries.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs.append(lib)
    return libs


def source(csrc: Path, name: str, edits=()) -> str:
    """csrc/name with the headers it includes inlined, so a copy builds
    anywhere and an edit may patch a helper of common.cuh, and each (old,
    new) edit applied; a missing pattern exits."""
    text = (csrc / name).read_text()
    for inc in ("slic_common.cuh", "common.cuh"):  # slic_common.cuh includes common.cuh
        text = text.replace(f'#include "{inc}"', (csrc / inc).read_text())
    for old, new in edits:
        if old not in text:
            sys.exit(f"pattern not found in {name}: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas(csrc: Path, names: list, tag: str) -> None:
    """Print ptxas's registers, shared memory and spills of each source."""
    nvcc = _kernels._find_nvcc()
    for src in names:
        res = subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              str(csrc / src), "-o", "/dev/null"],
                             capture_output=True, text=True)
        lines = [ln for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "rror" in ln or "Compiling" in ln]
        print(f"ptxas {tag} {src}:\n  " + "\n  ".join(lines), flush=True)


EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int gcis_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch():
    """A function that launches an empty kernel on the current stream: back
    to back, the one-launch floor."""
    (lib,) = build([EMPTY_SOURCE], ["empty_kernel"], {"gcis_empty": [ctypes.c_void_p]})
    return lambda: lib.gcis_empty(torch.cuda.current_stream().cuda_stream)


def blobs(b, d, n, seed, dev):
    """A contiguous (B, D, N) float32 buffer of three well-separated blobs.
    Contiguous: the wrappers would copy a strided buffer (an extra kernel in
    a timing), and another commit's C entry points read it as it lies."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=2.0, size=(b, 3, d))
    lab = rng.integers(0, 3, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2), np.float32)).to(dev)

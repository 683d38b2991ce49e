"""Build, load and call the port's hand-written Hopper kernels (``csrc/``).

At first use one ``nvcc`` process per ``csrc/*.cu``, all started together,
compiles the sources for ``sm_90a``, and a last ``nvcc`` links the objects
into one shared library with a plain C interface (compiling side by side,
the first use waits about as long as the slowest source, not their sum,
which keeps the build well inside ``chip_smoke.py``'s time limit as the
sources grow; any failed compile or link raises with its log). The library goes to
``_build/`` under a name that carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads the cached build. It is
loaded with ``ctypes``: every pointer and the CUDA stream travel as ``c_void_p``,
every C entry point returns ``cudaGetLastError()`` after its launches, and
:func:`launch` raises on a non-zero code, and under ``utils.debug.debug_nans``
checks the launch's outputs for NaN.

Without ``nvcc`` (or without a card) the kernels cannot run, and the
wrappers raise: no wrapper falls back to its plain PyTorch version for a
CUDA tensor. The plain versions serve CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from gabor_color_image_segmentation_tpu_torch.utils.debug import check_kernel_outputs

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# argument types of every C entry point, in csrc/ declaration order
_SIGNATURES = {
    "gcis_slic": [_P] * 6 + [_I] * 8 + [_F] * 3 + [_P],
    "gcis_slic_w3_pass": [_P] * 6 + [_I] * 7 + [_F] * 3 + [_P],
    "gcis_slic_w3_update": [_P] * 2 + [_I] * 5 + [_P],
    "gcis_slic_band_pass": [_P] * 4 + [_I] * 8 + [_F] * 3 + [_P],
    "gcis_slic_band_update": [_P] * 2 + [_I] * 7 + [_P],
    "gcis_slic_w5": [_P] * 5 + [_I] * 15 + [_F] * 3 + [_P],
    "gcis_slic_w5_active_clusters": [_I] * 3 + [_P] * 2,
    "gcis_enforce_connectivity": [_P] * 6 + [_I] * 5 + [_P],
    "gcis_table_lookup": [_P] * 3 + [_I] * 3 + [_P],
    "gcis_gabor_group": [_P] * 19 + [_I] * 10 + [_P],
    "gcis_lloyd_chw": [_P] * 8 + [_I] * 11 + [_P],
    "gcis_maximin_chw": [_P] * 8 + [_I] * 5 + [_P],
    "gcis_coarse_centers": [_P] * 3 + [_I] * 9 + [_P],
    "gcis_coarse_active_clusters": [_I] * 2 + [_P] * 2,
    "gcis_lloyd_t": [_P] * 6 + [_I] * 7 + [_P],
    "gcis_maximin_t": [_P] * 7 + [_I] * 6 + [_P],
    "gcis_em_pass": [_P] * 8 + [_I] * 8 + [_P],
    "gcis_precision_chol": [_P] * 3 + [_I] * 2 + [_P],
    "gcis_precision_chol_params": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_P],
    "gcis_lloyd_rows": [_P] * 8 + [_I] * 10 + [_P],
    "gcis_superpixel_moments": [_P] * 6 + [_I] * 9 + [_P],
    "gcis_std_moments": [_P] * 3 + [_I] * 12 + [_P],
    "gcis_std_affine": [_P] * 5 + [_I] * 5 + [_D] * 6 + [_P],
    "gcis_std_apply": [_P] * 6 + [_I] * 16 + [_P],
}


def _find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    return None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the build for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgcis_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet. Raises RuntimeError when nvcc is missing or fails."""
    out = library_path()
    if not out.exists():
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "the CUDA kernels of gabor_color_image_segmentation_tpu_torch "
                "need nvcc (the CUDA toolkit) to build; none was found on "
                "PATH or under CUDA_HOME. The plain PyTorch versions serve "
                "CPU tensors only."
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        srcs = [src for src in _sources() if src.suffix == ".cu"]
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [(proc.communicate()[0], proc.returncode) for proc in procs]
        failed = [log for log, rc in logs if rc != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                   *(str(o) for o in objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(link.stdout + link.stderr)
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gcis_error_string.argtypes = [ctypes.c_int]
    lib.gcis_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args, outputs: tuple = ()) -> None:
    """Call C entry point ``name`` on the current CUDA stream (appended as
    the last argument) and raise if it reports a CUDA error. ``outputs``,
    the tensors the launch writes, are checked for NaN under
    ``utils.debug.debug_nans`` (the kernels write outside the dispatcher
    that mode watches)."""
    lib = library()
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} failed: CUDA error {rc} "
            f"({lib.gcis_error_string(rc).decode()})"
        )
    if outputs:
        check_kernel_outputs(name, outputs)


def sm_count(device: torch.device) -> int:
    """The card's SM count, for a kernel's launch plan. The kernels are
    built (or loaded) first, so a missing nvcc raises here as at a launch."""
    library()
    return torch.cuda.get_device_properties(device).multi_processor_count


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when all lie on one CUDA device (launch the kernel). Anything else
    raises: there is no fallback."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(
        f"kernel inputs must all lie on the CPU or on one CUDA device, got "
        f"{sorted(str(d) for d in devices)}"
    )


def check(cond: bool, msg: str) -> None:
    """Raise ValueError(msg) unless cond: the wrappers' input contract."""
    if not cond:
        raise ValueError(msg)


def storage_code(dtype: torch.dtype) -> int:
    """The kernels' storage flag: 0 for float32, 1 for bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")

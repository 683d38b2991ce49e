"""PyTorch port: does it do everything the JAX package does?

For every module of the JAX package this parses the source (AST, so JAX is
not imported) and lists its public top-level functions, classes and
UPPER_CASE constants (in an ``__init__.py``, the names in ``__all__``), with
each function's parameter names. The paired module of the port must define
each name, and each function must take each of the parameter names. The
pairing: the port's module at the same path, or for a ``*_pallas.py`` the
module that the kernel table names (``PAIRED``).

Two explicit tables hold the exceptions, each entry with its reason:
``RENAMES`` (a name or a parameter the port carries under another name) and
``NOT_CARRIED`` (what answers the TPU's layouts, the JAX precision enums,
``enable_compilation_cache``, the benchmark's golden-path timer, and the
parameters the single-controller mesh replaces). An entry that no longer
names anything of the JAX package fails its module's case, so the tables
cannot go stale. One case per JAX module.
"""

from __future__ import annotations

import ast
import fnmatch
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "gabor_color_image_segmentation_tpu"
PORT = "gabor_color_image_segmentation_tpu_torch"

# JAX module -> the port's module, where the path differs (the kernel table)
PAIRED = {
    "models/chol_pallas.py": "models/chol.py",
    "models/connectivity_pallas.py": "models/connectivity.py",
    "models/gmm_pallas.py": "models/gmm_fused.py",
    "models/graph_pallas.py": "models/graph_fused.py",
    "models/kmeans_pallas.py": "models/kmeans_fused.py",
    "models/slic_pallas.py": "models/slic_fused.py",
    "ops/fused_pallas.py": "ops/fused.py",
}

# (JAX module, name) or (JAX module, function, parameter) -> (the port's
# module or None for the paired one, the port's name, the reason). A
# module of "*" matches every module, and a name may be a pattern.
RENAMES = {
    ("*", "*_jax"): (None, "*_torch", "the tensor versions run on torch tensors"),
    ("models/__init__.py", "kmeans"): (
        "models/kmeans.py", "kmeans", "the package's name kmeans stays the module, which "
        "the port's code and tests import; the function is models.kmeans.kmeans"),
    ("models/chol_pallas.py", "precision_chol_pallas"): (
        None, "precision_chol", "K9's wrapper; the suffix named the Pallas route"),
    ("models/chol_pallas.py", "precision_chol_params_pallas"): (
        None, "precision_chol_params", "K10's wrapper; the suffix named the Pallas route"),
    ("models/chol_pallas.py", "precision_chol_params_pallas", "moments"): (
        None, "counts, sums, scatter", "the packed moment-scatter as its three unpadded parts"),
    ("models/kmeans_pallas.py", "fused_solver_eligible"): (
        "models/kmeans.py", "fused_solver_ready",
        "the reference's guarded form of the same gate, with the card in place of the TPU"),
    ("models/kmeans_pallas.py", "kmeans_fused_t_xt", "xt"): (
        None, "x", "the unpadded (B, D, N) buffer in place of the padded xt layout"),
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "xt"): (
        None, "x", "the unpadded (B, D, N) buffer in place of the padded xt layout"),
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "fit_xp"): (
        None, "fit_x", "the fit grid's unpadded (B, D, m) buffer"),
    ("models/graph_pallas.py", "superpixel_moments_fused_t", "feats"): (
        None, "feats_t", "K17 takes the channel-major (B, D, N) buffer it reads"),
    ("models/slic.py", "slic_moments", "flat"): (
        None, "rows", "the batched (B, N, 5) [L, a, b, y, x] rows"),
    ("ops/features.py", "coherence_weights_cm", "groups"): (
        None, "energies", "one (B, E, H, W) energy tensor: K1 writes no per-group buffers"),
    ("ops/features.py", "fold_coherence_affine", "groups"): (
        None, "energies", "one (B, E, H, W) energy tensor: K1 writes no per-group buffers"),
    ("ops/features.py", "assemble_xp_from_affine", "pe_cm"): (
        None, "pe", "the pooled (B, E, h, w) energies, one tensor"),
    ("ops/fused_pallas.py", "gabor_energies_fused", "bank"): (
        None, "groups", "the bank's device tensors (ops.bank.bank_tensors)"),
    ("ops/tiled.py", "gabor_energies_tiled", "bank"): (
        None, "groups", "the bank's device tensors (ops.bank.bank_tensors)"),
    ("parallel/tiled_graph.py", "slic_sharded", "lab"): (
        None, "labs", "one strip a shard: a list on the single-controller mesh"),
    ("parallel/tiled_graph.py", "graph_cut_strip", "lab"): (
        None, "labs", "one strip a shard: a list on the single-controller mesh"),
    ("parallel/tiling.py", "kmeans_sharded", "x"): (
        None, "xs", "one strip a shard: a list on the single-controller mesh"),
}

_MESH = ("the single-controller mesh (parallel/mesh.py) is passed as mesh and axis; "
         "there is no named axis of a traced program")
_XT = "the TPU's padded transposed xt layout; the port's buffers are unpadded (B, D, N)"
_GOLDEN = ("times the numpy golden path, and the port imports no golden/ module (the "
           "ground rule); vs_baseline divides by the copied CPU_BASELINE_MP_S")
NOT_CARRIED = {
    ("benchmark.py", "measure_cpu_golden"): _GOLDEN,
    ("benchmark.py", "run_benchmark", "measure_cpu"): _GOLDEN,
    ("benchmark.py", "run_benchmark", "cpu_images"): _GOLDEN,
    ("utils/jit_cache.py",): ("JAX's persistent compilation cache; the kernels' build is "
                              "cached by source hash in _build/ (_kernels.py)"),
    ("ops/precision.py", "HIGHEST"): "a JAX matmul precision enum; the port turns TF32 off",
    ("ops/precision.py", "DEFAULT"): "a JAX matmul precision enum; the port turns TF32 off",
    ("ops/precision.py", "precision_for"): ("picks a JAX matmul precision; the port's "
                                            "policy is set_policy (TF32 off, both modes)"),
    ("models/kmeans_pallas.py", "build_xt"): _XT,
    ("models/kmeans_pallas.py", "xt_geometry"): _XT,
    ("models/kmeans_pallas.py", "kmeans_fused_t_xt", "d"): _XT,
    ("models/kmeans_pallas.py", "kmeans_fused_t_xt", "n"): _XT,
    ("models/kmeans_pallas.py", "kmeans_fused_t_xt", "xp"): (
        "the pooled xt twin; the port pools its (B, D, N) buffer itself (hw)"),
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "d"): _XT,
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "n"): _XT,
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "hw"): (
        "the fit grid comes as fit_x, built by the caller on the pooled energies"),
    ("models/gmm_pallas.py", "gmm_fused_t_xt", "fit_pool"): (
        "the fit grid comes as fit_x, built by the caller on the pooled energies"),
    ("models/chol_pallas.py", "precision_chol_pallas", "d"): (
        "the TPU's padded matrices; the port's (M, d, d) carry d in their shape"),
    ("models/chol_pallas.py", "precision_chol_params_pallas", "d"): (
        "the TPU's padded matrices; the port's (B, k, d, d) carry d in their shape"),
    ("ops/features.py", "assemble_features_t"): (
        _XT + "; the labels-only path builds its buffer with assemble_xp_from_affine "
        "(pipeline._normalised_buffer)"),
    ("ops/features.py", "assemble_features_t_pooled"): (
        _XT + "; the multigrid twin is pooled from the raw rows (pipeline."
        "segment_chw_grouped, kmeans_fused_t_xt)"),
    ("ops/features.py", "assemble_xp_from_affine", "dp"): _XT,
    ("ops/features.py", "assemble_xp_from_affine", "m_pad"): _XT,
    ("ops/fused_pallas.py", "gabor_energies_fused", "channel_major"): (
        "K1 always writes the channel-major (B, E, H, W) layout"),
    ("ops/fused_pallas.py", "gabor_energies_fused", "grouped"): (
        "K1 writes one (B, E, H, W) tensor; the per-group buffers answered VMEM"),
    ("parallel/tiled_graph.py", "slic_sharded", "axis_name"): _MESH,
    ("parallel/tiled_graph.py", "enforce_connectivity_sharded", "axis_name"): _MESH,
    ("parallel/tiled_graph.py", "enforce_connectivity_sharded", "sync_axes"): _MESH,
    ("parallel/tiled_graph.py", "superpixel_means_sharded", "axis_name"): _MESH,
    ("parallel/tiled_graph.py", "graph_cut_strip", "axis_name"): _MESH,
    ("parallel/tiled_graph.py", "graph_cut_strip", "sync_axes"): _MESH,
    ("parallel/tiling.py", "kmeans_sharded", "axis_name"): _MESH,
}

# The entry points ported last: none of them may be excused by either table.
PORTED = [
    ("models/graph.py", "resolve_graph_impls"),
    ("models/graph.py", "ncut_from_superpixels"),
    ("models/graph.py", "ncut_segment"),
    ("models/graph.py", "graph_segment_batch"),
    ("models/slic.py", "slic"),
    ("models/slic.py", "slic_assign"),
    ("models/slic.py", "enforce_connectivity_device"),
    ("models/slic_pallas.py", "slic_fused"),
    ("models/slic_pallas.py", "slic_batch", "impl"),
    ("models/kmeans_chw.py", "kmeans_fused_chw", "coarse_iters"),
    ("models/kmeans_chw.py", "kmeans_fused_chw", "pooled"),
    ("models/kmeans_chw.py", "kmeans_fused_chw", "eps"),
    ("models/kmeans_chw.py", "kmeans_fused_chw", "energies_cm"),
    ("ops/lookup.py", "table_lookup_int"),
    ("eval.py", "evaluate", "debug_nans"),
    ("benchmark.py", "build_batch"),
    ("benchmark.py", "bench_device"),
    ("benchmark.py", "run_benchmark"),
]


def _jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.py"))


def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def public_api(path: Path) -> dict:
    """name -> parameter names (functions) or None (classes, constants) of
    the module's public top level; an ``__init__.py``'s ``__all__``."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__" and path.name == "__init__.py":
                    out.update({n: None for n in ast.literal_eval(node.value)})
                elif isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = None
    return {n: p for n, p in out.items() if not n.startswith("_")}


def _module_name(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join((PORT,) + parts).removesuffix(".__init__")


def _lookup(table: dict, key: tuple):
    """The entry of ``table`` that ``key`` matches (module "*" and name
    patterns), with its key, or (None, None)."""
    for k, v in table.items():
        if len(k) == len(key) and all(fnmatch.fnmatchcase(b, a) for a, b in zip(k, key)):
            return k, v
    return None, None


def _port_params(obj) -> list:
    return list(inspect.signature(obj).parameters)


def test_pairing_covers_every_jax_module():
    mods = _jax_modules()
    assert len(mods) >= 40
    for rel in PAIRED:
        assert rel in mods, rel


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_carries_the_module(rel):
    """Every public name and parameter of the JAX module has its counterpart
    in the paired port module, or an entry, with its reason, in RENAMES or
    NOT_CARRIED."""
    used = set()
    if (rel,) in NOT_CARRIED:
        used.add((rel,))
        assert not (ROOT / PORT / PAIRED.get(rel, rel)).exists(), \
            f"{rel} is excused as a whole but the port has it"
        return
    port_mod = importlib.import_module(_module_name(PAIRED.get(rel, rel)))
    missing = []
    for name, params in public_api(JAX_DIR / rel).items():
        key, skip = _lookup(NOT_CARRIED, (rel, name))
        if skip:
            used.add(key)
            continue
        mod, port_name = port_mod, name
        key, ren = _lookup(RENAMES, (rel, name))
        if ren:
            used.add(key)
            target_mod, pattern, _ = ren
            if target_mod:
                mod = importlib.import_module(_module_name(target_mod))
            port_name = (name[:-len(key[1]) + 1] + pattern[1:] if pattern.startswith("*")
                         else pattern)
        obj = getattr(mod, port_name, None)
        if obj is None:
            missing.append(f"{name} (as {mod.__name__}.{port_name})")
            continue
        if params is None or not callable(obj):
            continue
        have = _port_params(obj)
        for p in params:
            if p in have:
                continue
            k_skip, skip = _lookup(NOT_CARRIED, (rel, name, p))
            k_ren, ren = _lookup(RENAMES, (rel, name, p))
            if skip:
                used.add(k_skip)
            elif ren and all(q.strip() in have for q in ren[1].split(",")):
                used.add(k_ren)
            else:
                missing.append(f"{name}({p}=...)")
    assert not missing, f"the port's {port_mod.__name__} lacks {missing}"
    # every entry of the tables for this module names something of it
    stale = [k for k in (*RENAMES, *NOT_CARRIED) if k[0] == rel and k not in used]
    assert not stale, f"table entries that name nothing of {rel}: {stale}"


def test_tables_give_reasons():
    for k, v in RENAMES.items():
        assert len(v) == 3 and v[2].strip(), k
    for k, v in NOT_CARRIED.items():
        assert isinstance(v, str) and v.strip(), k


@pytest.mark.parametrize("entry", PORTED, ids=lambda e: "::".join(e[1:]))
def test_ported_entry_points_are_not_excused(entry):
    """The names in PORTED sit in neither table, and the JAX
    package has them."""
    rel = entry[0]
    assert _lookup(RENAMES, entry) == (None, None)
    assert _lookup(NOT_CARRIED, entry) == (None, None)
    assert _lookup(NOT_CARRIED, (rel,)) == (None, None)
    api = public_api(JAX_DIR / rel)
    assert entry[1] in api
    if len(entry) == 3:
        assert entry[2] in api[entry[1]]

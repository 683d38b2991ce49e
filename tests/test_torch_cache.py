"""PyTorch port, the HDF5 feature cache (utils/cache.py) against the JAX
package's: equal fingerprints for every preset (and a changed bank or
colour space changes them), a round trip of numpy arrays and of tensors
(bfloat16 widened to float32), and a file written by each package read by
the other. Also the port's demo (examples/demo_torch.py) on the CPU at a
small size."""

import importlib.util
import os

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.utils.cache import FeatureCache as JaxFeatureCache
from gabor_color_image_segmentation_tpu_torch.config import BankConfig, PRESETS, preset
from gabor_color_image_segmentation_tpu_torch.utils.cache import FeatureCache

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fingerprint_equals_reference(name):
    assert FeatureCache.fingerprint(preset(name)) == JaxFeatureCache.fingerprint(
        jax_preset(name))


def test_fingerprint_follows_bank_and_colour_space():
    cfg = preset("config0")
    fp = FeatureCache.fingerprint(cfg)
    assert FeatureCache.fingerprint(cfg.replace(color_space="rgb")) != fp
    assert FeatureCache.fingerprint(cfg.replace(bank=BankConfig(orientations=3))) != fp
    assert FeatureCache.fingerprint(cfg.replace(batch_size=7)) == fp


def test_round_trip(tmp_path):
    cache = FeatureCache(str(tmp_path / "sub" / "feats.h5"))
    cfg = preset("config1")
    assert cache.get("img0", cfg) is None
    x = np.random.default_rng(0).normal(size=(12, 16, 243)).astype(np.float32)
    cache.put("img0", cfg, x)
    got = cache.get("img0", cfg)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.array_equal(got, x)
    assert cache.get("img0", preset("config0")) is None
    t = torch.from_numpy(x[..., :5]).to(torch.bfloat16)
    cache.put("img0", cfg, t)  # overwrites
    again = cache.get("img0", cfg)
    assert again.dtype == np.float32 and np.array_equal(again, t.to(torch.float32).numpy())
    cache.put("img1", cfg, torch.arange(6, dtype=torch.int32).reshape(2, 3))
    assert cache.get("img1", cfg).tolist() == [[0, 1, 2], [3, 4, 5]]
    with h5py.File(cache.path, "r") as f:
        assert sorted(f[FeatureCache.fingerprint(cfg)].keys()) == ["img0", "img1"]


def test_files_cross_read(tmp_path):
    x = np.random.default_rng(1).normal(size=(8, 9, 39)).astype(np.float32)
    y = x[::-1].copy()
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "ref.h5")
    FeatureCache(ours).put("a", preset("config0"), torch.from_numpy(x))
    JaxFeatureCache(theirs).put("b", jax_preset("config0"), y)
    assert np.array_equal(JaxFeatureCache(ours).get("a", jax_preset("config0")), x)
    assert np.array_equal(FeatureCache(theirs).get("b", preset("config0")), y)
    assert FeatureCache(theirs).get("b", preset("config1")) is None


def test_demo_runs_on_cpu(tmp_path, capsys):
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "demo_torch.py")
    spec = importlib.util.spec_from_file_location("demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    rows = demo.main(["--device", "cpu", "--hw", "96", "128", "--out-dir", str(tmp_path)])
    assert [r[0] for r in rows] == ["kmeans", "gmm", "slic_ncut"]
    for name, labels, pri, f in rows:
        assert labels.shape == (96, 128) and 0.0 <= pri <= 1.0 and 0.0 <= f <= 1.0
        assert os.path.exists(tmp_path / f"{name}.png")
    assert "PRI=" in capsys.readouterr().out


def test_demo_imports_no_jax():
    """examples/demo_torch.py names neither jax nor the JAX package in any
    import statement."""
    import ast

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "demo_torch.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "jaxlib")
                          or m.split(".")[0] == "gabor_color_image_segmentation_tpu"]

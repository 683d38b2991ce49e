"""PyTorch port, the single-controller mesh (parallel/mesh.py) and the
data-parallel leg (parallel/sharding.py), on repeated CPU devices.

- ``psum`` adds the shards in index order on the first shard's device and
  gives every shard the same bits; integer sums stay integer; ``pmean``,
  ``all_gather`` in shard order, the ``ppermute`` ring (zeros where no pair
  sends); the counters by kind, shared by a sub-mesh; ``any_true``'s host
  syncs; ``make_mesh``'s errors.
- ``segment_batch_sharded`` at config0 and on a config3 toy: labels and
  features bit-equal to ``segment_batch`` run shard by shard (the local
  batch picks the routes), no collective; B not divisible by the mesh
  raises."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch
from gabor_color_image_segmentation_tpu_torch.parallel import make_mesh, segment_batch_sharded
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh
from gabor_color_image_segmentation_tpu_torch.parallel.sharding import make_sharded_fn

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def test_psum_order_and_bits():
    """float32 values whose sum depends on the order: the result is the
    index-order sum, every shard holds it bit for bit."""
    mesh = Mesh(CPU8, ("space",))
    vals = [torch.tensor([v], dtype=torch.float32)
            for v in (1e8, 1.0, -1e8, 3.0, 0.5, 1e-3, -0.25, 7.0)]
    out = mesh.psum(vals, "space")
    want = vals[0].clone()
    for v in vals[1:]:
        want = want + v
    assert len(out) == 8 and all(torch.equal(o, want) for o in out)
    assert want.item() != sum(float(v) for v in sorted(vals, key=lambda t: abs(t.item())))
    ints = mesh.psum([torch.arange(3, dtype=torch.int32) * i for i in range(8)], "space")
    assert ints[0].dtype == torch.int32 and ints[0].tolist() == [0, 28, 56]
    means = mesh.pmean([torch.full((2,), float(i)) for i in range(8)], "space")
    assert torch.equal(means[3], torch.full((2,), 3.5))
    assert mesh.collectives == {"psum": 2, "pmean": 1, "all_gather": 0, "ppermute": 0}


def test_all_gather_and_ppermute_ring():
    mesh = Mesh(["cpu"] * 4, ("space",))
    vals = [torch.full((2,), float(i)) for i in range(4)]
    gathered = mesh.all_gather(vals, "space")
    assert all(torch.equal(g, torch.stack(vals)) for g in gathered)
    ring = mesh.ppermute(vals, "space", [(i, (i + 1) % 4) for i in range(4)])
    assert [r[0].item() for r in ring] == [3.0, 0.0, 1.0, 2.0]
    back = mesh.ppermute(vals, "space", [(i, (i - 1) % 4) for i in range(4)])
    assert [r[0].item() for r in back] == [1.0, 2.0, 3.0, 0.0]
    partial = mesh.ppermute(vals, "space", [(0, 2)])
    assert [r[0].item() for r in partial] == [0.0, 0.0, 0.0, 0.0] and partial[2].sum() == 0
    partial = mesh.ppermute(vals, "space", [(3, 1)])
    assert [r[0].item() for r in partial] == [0.0, 3.0, 0.0, 0.0]
    assert mesh.collectives["all_gather"] == 1 and mesh.collectives["ppermute"] == 4


def test_counters_submesh_and_syncs():
    mesh = Mesh(np.asarray(CPU8, dtype=object).reshape(4, 2), ("batch", "space"))
    assert mesh.shape == {"batch": 4, "space": 2} and mesh.size == 8
    sub = mesh.along("space", batch=2)
    assert sub.shape == {"space": 2}
    sub.psum([torch.ones(1), torch.ones(1)], "space")
    assert mesh.collectives["psum"] == 1
    assert sub.any_true([torch.tensor(False), torch.tensor(True)], "space") is True
    assert sub.any_true([torch.tensor(False), torch.tensor(False)], "space") is False
    assert mesh.host_syncs == 2 and mesh.collectives["psum"] == 3
    mesh.reset_counts()
    assert sub.host_syncs == 0 and not any(sub.collectives.values())
    with pytest.raises(ValueError, match="shards"):
        sub.psum([torch.ones(1)] * 3, "space")
    with pytest.raises(ValueError, match="along"):
        mesh.psum([torch.ones(1)] * 8, "space")


def test_make_mesh_errors(monkeypatch):
    mesh = make_mesh(4, devices=CPU8)
    assert mesh.shape == {"batch": 4}
    assert all(d == torch.device("cpu") for d in mesh.axis_devices("batch"))
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh(2)


def _shard_by_shard(imgs, cfg, n, with_features=True):
    bl = len(imgs) // n
    outs = [segment_batch(imgs[i * bl:(i + 1) * bl], cfg, None, with_features, "cpu")
            for i in range(n)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]) if with_features else None)


@pytest.mark.parametrize("with_features", [True, False])
def test_dp_config0_bit_equal_shard_by_shard(with_features):
    cfg = preset("config0")
    imgs = np.stack([synthetic_mosaic(64, 64, n_regions=3, seed=60 + i)[0] for i in range(4)])
    mesh = make_mesh(4, devices=CPU8)
    labels, feats = segment_batch_sharded(imgs, cfg, None, mesh, with_features)
    ref_l, ref_f = _shard_by_shard(imgs, cfg, 4, with_features)
    assert labels.dtype == torch.int32 and labels.shape == (4, 64, 64)
    assert torch.equal(labels, ref_l)
    if with_features:
        assert torch.equal(feats, ref_f)
    else:
        assert feats is None
    assert not any(mesh.collectives.values()) and mesh.host_syncs == 0


def test_dp_config3_toy_bit_equal_shard_by_shard():
    """A config3 toy at a local batch of 2: the local batch picks the graph
    stage's route, so the labels are segment_batch's shard by shard."""
    cfg = preset("config3").replace(image_hw=(64, 96), feature_impl="modulated")
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=96,
                                                slic_compactness=10.0, n_regions=4,
                                                affinity_sigma_scale=1.0))
    imgs = np.stack([synthetic_mosaic(64, 96, n_regions=4, seed=50 + i)[0] for i in range(4)])
    mesh = make_mesh(2, devices=CPU8)
    labels, feats = make_sharded_fn(cfg, None, mesh)(imgs)
    ref_l, ref_f = _shard_by_shard(imgs, cfg, 2)
    assert torch.equal(labels, ref_l) and torch.equal(feats, ref_f)
    assert not any(mesh.collectives.values())


def test_dp_batch_not_divisible_raises():
    cfg = preset("config0")
    imgs = np.zeros((3, 64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="B=3 must divide over 2"):
        segment_batch_sharded(imgs, cfg, None, make_mesh(2, devices=CPU8))

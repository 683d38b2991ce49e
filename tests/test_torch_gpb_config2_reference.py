"""The benchmark's plain reference of config2-gmm-bf16
(gpubench/reference/config2-gmm-bf16.py: plain torch, no kernel of the
port) against the port's CPU path, ``segment_images`` with the
configuration file's preset, on frames made from a seed at two small
sizes: the labels equal pixel for pixel, ids and all. The reference
imports nothing of the port or of JAX, and runs with TF32 off."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import harness, spec, traffic
from gpubench.reference import common

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
NAME = "config2-gmm-bf16"
CONFIG = json.loads((REPO / f"gpubench/configs/{NAME}.json").read_text())


def _frames(seed, hw):
    mix = json.loads((REPO / "gpubench/workloads/bsds-val-b50.json").read_text())
    mix.update(frame_hw=list(hw), pool=2, batch=2)
    return traffic.make_pool(seed, mix, "cpu")


@pytest.mark.parametrize("seed,hw", [(11, (72, 96)), (2 ** 31 + 13, (128, 160))])
def test_reference_equals_the_port_cpu_path(seed, hw):
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cfg = harness.pipeline_config(CONFIG)
    assert cfg.cluster.method == "gmm" and cfg.dtype == "bfloat16"
    rgb = _frames(seed, hw)
    got = segment_images(rgb, cfg, make_bank(cfg.bank), device="cpu").numpy()
    common.set_policy()
    ref = spec.reference(REPO, NAME)
    want = ref.segment(torch.from_numpy(rgb), CONFIG, common.Storage("bfloat16")).numpy()
    assert got.shape == want.shape == rgb.shape[:3]
    assert np.array_equal(got, want)


def test_reference_imports_no_port_and_no_jax():
    code = ("import sys, json; from pathlib import Path; "
            "from gpubench import spec; "
            f"spec.reference(Path({str(REPO)!r}), {NAME!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gabor_color_image_segmentation_tpu', "
            "'gabor_color_image_segmentation_tpu_torch')); print(json.dumps(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    common.set_policy()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32

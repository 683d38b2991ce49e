"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced (labels swapped between frames, a
quarter of a frame relabelled, a label outside [0, k)), and a batch
that fails. The other faults of the contract (a step that returns its
state unchanged, half of a batch left out of a mean, an exchange between
chips left out) belong to training and to cells across chips; these cells
have neither."""

from __future__ import annotations

import json

import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gpubench.tests.conftest import REPO, TINY, make_root

CELLS = tuple(w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"])


def _swap_frames(labels):
    return labels.roll(1, dims=0)


def _relabel_quarter(labels):
    out = labels.clone()
    h, w = out.shape[1:]
    out[0, : h // 2, : w // 2] = (out[0, : h // 2, : w // 2] + 1) % 5
    return out


def _outside_k(labels):
    out = labels.clone()
    out[-1, 0, 0] = 5
    return out


FAULTS = {"swap_frames": _swap_frames, "relabel_quarter": _relabel_quarter,
          "outside_k": _outside_k}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, run_cell, cell):
    rc, result, _ = run_cell(tiny_root, cell, seed=123)
    assert rc == 0 and result["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(tiny_root, run_cell, monkeypatch, cell, fault):
    real = pipeline.segment_images

    def broken(*args, **kwargs):
        return FAULTS[fault](real(*args, **kwargs))

    monkeypatch.setattr(pipeline, "segment_images", broken)
    rc, result, _ = run_cell(tiny_root, cell, seed=123)
    assert rc == 0 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_quarter_of_each_frame_relabelled_at_the_cells_batch_is_not_correct(
        tmp_path, run_cell, monkeypatch, cell):
    """At the cell's own batch (small frames), one batch's answer altered: a
    quarter of each of its frames relabelled."""
    from gpubench import spec

    batch = spec.load_cell(REPO, cell).traffic["batch"]
    root = make_root(tmp_path, **dict(TINY, batch=batch, pool=batch))
    real = pipeline.segment_images

    def broken(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        h, w = out.shape[1:]
        out[:, : h // 2, : w // 2] = (out[:, : h // 2, : w // 2] + 1) % 5
        return out

    monkeypatch.setattr(pipeline, "segment_images", broken)
    rc, result, _ = run_cell(root, cell, seed=123)
    assert rc == 0 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_failed_batch_is_not_correct(tiny_root, run_cell, monkeypatch):
    real = pipeline.segment_images
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:  # the first window batch after the one warm-up batch
            raise torch.cuda.OutOfMemoryError("planted")
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "segment_images", flaky)
    rc, result, _ = run_cell(tiny_root, CELLS[0], seed=123)
    assert rc == 0 and result["failed"] >= 1 and result["correct"] is False

"""The control of ``correct``: the reference with its stored tensors in
float8 e4m3 (the precision below the configurations' bf16) put in the
program's place fails a configuration's limits, where the program passes
them. On the CPU at a test's size against the port's CPU path; on the
card (``-m cuda``) at each cell's own size on three seeds. Both go through
the comparison a run makes (``harness.reference_numbers``)."""

from __future__ import annotations

import json

import pytest

from gpubench import harness, judge, spec, traffic
from gpubench.tests.conftest import REPO

CONFIGS = {w["config"]: w["name"]
           for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]}


def _fails(numbers, limits):
    return not judge.verdict(numbers, limits)[0]


def _readings(cell_name, seed, device, mix_changes=None):
    """(program's numbers, control's numbers, the limits) over the batches a
    run with ``seed`` checks, through the run's own comparison."""
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cell = spec.load_cell(REPO, cell_name)
    mix = dict(cell.traffic, **(mix_changes or {}))
    cfg = harness.pipeline_config(cell.config)
    bank = make_bank(cfg.bank)
    batches = traffic.batches(traffic.make_pool(seed, mix, device), mix["batch"])
    frames = {d: batches[d] for d in harness.checked_ids(seed, len(batches),
                                                         mix["check_batches"])}
    prog = {d: segment_images(f, cfg, bank, device=device).cpu().numpy()
            for d, f in frames.items()}
    ctl = {d: harness.reference_labels(cell, f, device, "fp8") for d, f in frames.items()}
    numbers = harness.reference_numbers(cell, frames, [prog, ctl], device)
    return numbers[0], numbers[1], cell.config["limits"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [4, 2 ** 31 + 5])
def test_control_fails_where_the_program_passes_cpu(config, seed):
    small = {"frame_hw": [96, 128], "batch": 2, "pool": 2, "check_batches": 1}
    prog, ctl, limits = _readings(CONFIGS[config], seed, "cpu", small)
    assert not _fails(prog, limits), prog
    assert _fails(ctl, limits), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 102, 3 * 10 ** 9 + 103])
def test_control_fails_at_the_cells_size_on_the_card(cuda_card, config, seed):
    prog, ctl, limits = _readings(CONFIGS[config], seed, cuda_card)
    print(json.dumps({"config": config, "seed": seed, "program": prog, "control": ctl}))
    assert not _fails(prog, limits), prog
    assert _fails(ctl, limits), ctl

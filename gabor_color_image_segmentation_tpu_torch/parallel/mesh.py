"""A single-controller device mesh and its collectives (the port's
counterpart of ``jax.sharding.Mesh`` and the ``lax`` collectives the JAX
package's parallel/ uses: ``psum``, ``pmean``, ``all_gather``,
``ppermute``; ``axis_index`` is a shard's position in the list and
``axis_size`` ``mesh.shape[axis]``).

The reference runs one ``shard_map`` program over a mesh, and its tests put
eight fake CPU devices on one host. Here one Python process drives the N
shards of an axis in lockstep: a per-shard value is a list indexed by the
shard's position along the axis (its ``axis_index``), each entry on that
shard's device, and a collective takes the whole list and returns one.
Devices may repeat (eight shards on ``cuda:0``, as the reference's tests
put eight shards on one CPU); on a machine with N cards the same code
drives N cards.

Collectives reduce in a fixed order: ``psum`` adds the shards in index
order 0 .. n - 1 on the first shard's device and copies the sum to every
shard's device, so every shard holds the same bits (no float atomics).
Integer sums stay integer. ``all_gather`` stacks in shard order;
``ppermute`` takes the reference's (source, destination) pairs, and a
shard that receives nothing gets zeros, as ``lax.ppermute``'s.

``mesh.collectives`` counts the collectives run, by kind, and
``mesh.host_syncs`` the flags read back to the host (``any_true``: the
fixpoint loops of parallel/tiled_graph.py; under a profiler each read is
a ``gcis.sync.mesh_any_true`` range, utils/trace.py). A sub-mesh along
one axis shares both counters with its parent.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.utils.trace import sync

COLLECTIVE_KINDS = ("psum", "pmean", "all_gather", "ppermute")


class Mesh:
    """Named axes over an array of ``torch.device``s (repeats allowed)."""

    def __init__(self, devices, axis_names: Sequence[str], _counters=None):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devs[idx] = torch.device(given[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devs.shape))
        if _counters is None:
            _counters = ({k: 0 for k in COLLECTIVE_KINDS}, [0])
        self.collectives, self._syncs = _counters

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def host_syncs(self) -> int:
        return self._syncs[0]

    def reset_counts(self) -> None:
        for k in self.collectives:
            self.collectives[k] = 0
        self._syncs[0] = 0

    def along(self, axis: str, **fixed: int) -> "Mesh":
        """The 1-D mesh along ``axis`` with every other axis fixed at the
        given index; it shares this mesh's counters."""
        idx = tuple(slice(None) if a == axis else fixed[a] for a in self.axis_names)
        return Mesh(list(self.devices[idx]), (axis,), (self.collectives, self._syncs))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of a 1-D mesh's shards, in shard order."""
        if self.axis_names != (axis,):
            raise ValueError(f"axis {axis!r} of a mesh {self.axis_names}: take .along() first")
        return list(self.devices)

    # -- collectives over a 1-D mesh's shards --------------------------------

    def _check(self, values: Sequence[torch.Tensor], axis: str) -> List[torch.device]:
        devs = self.axis_devices(axis)
        if len(values) != len(devs):
            raise ValueError(f"{len(values)} values for {len(devs)} shards of {axis!r}")
        return devs

    def psum(self, values: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """Sum over the shards in index order, every shard the same bits."""
        devs = self._check(values, axis)
        self.collectives["psum"] += 1
        return _replicate(_ordered_sum(values, devs[0]), devs)

    def pmean(self, values: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """psum / n, every shard the same bits."""
        devs = self._check(values, axis)
        self.collectives["pmean"] += 1
        return _replicate(_ordered_sum(values, devs[0]) / len(devs), devs)

    def all_gather(self, values: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """(n, ...) stack of the shards' values in shard order, on every shard."""
        devs = self._check(values, axis)
        self.collectives["all_gather"] += 1
        return _replicate(torch.stack([v.to(devs[0]) for v in values]), devs)

    def ppermute(self, values: Sequence[torch.Tensor], axis: str,
                 perm: Iterable[Tuple[int, int]]) -> List[torch.Tensor]:
        """Shard ``dst`` receives shard ``src``'s value for each (src, dst)
        pair; a shard named by no pair receives zeros."""
        devs = self._check(values, axis)
        self.collectives["ppermute"] += 1
        out = [torch.zeros_like(v) for v in values]
        for src, dst in perm:
            out[dst] = values[src].to(devs[dst])
        return out

    def any_true(self, flags: Sequence[torch.Tensor], axis: str) -> bool:
        """Global OR of per-shard booleans: a psum read back to the host
        (one host sync, counted in ``host_syncs``)."""
        total = self.psum([f.to(torch.int32).reshape(()) for f in flags], axis)[0]
        self._syncs[0] += 1
        return bool(sync("mesh_any_true", torch.Tensor.item, total) > 0)


def _ordered_sum(values: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    acc = values[0].to(dev)
    for v in values[1:]:
        acc = acc + v.to(dev)
    return acc


def _replicate(x: torch.Tensor, devs: Sequence[torch.device]) -> List[torch.Tensor]:
    """x on every shard's device (the same tensor where devices repeat)."""
    return [x.to(d) for d in devs]


def scatter_rows(x: torch.Tensor, devs: Sequence[torch.device], dim: int = 0) -> List[torch.Tensor]:
    """Split ``x`` into len(devs) equal blocks along ``dim``, block i on
    devs[i] (the caller checks divisibility)."""
    return [blk.to(d) for blk, d in zip(torch.chunk(x, len(devs), dim=dim), devs)]


def gather_rows(values: Sequence[torch.Tensor], dev: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' blocks concatenated along ``dim`` on ``dev`` (an output
    layout, not a collective of the program)."""
    return torch.cat([v.to(dev) for v in values], dim=dim)

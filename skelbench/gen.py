"""The traffic generator: builds a cell's base volume on the device from its
traffic file, and the chunks a run hands the program.

A traffic file (`skelbench/traffic/<name>.json`) is data: `{"steps":
[{"step": <kind>, <parameters>}, ...]}`, applied in order. Each kind is a
module `skelbench/steps/<kind>.py`, found by name (`steps/__init__.py`
says what it exposes), so a new kind of traffic comes as a new file. The
last step's labels are the base volume; a step that makes a voxel graph
(`merge`) hands it on, and the run gives it to the program.

Every chunk of a run is the base volume under a fresh permutation of its
nonzero ids, drawn from the run's `--seed`, so that every seed gives the
same work in another naming.
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import torch

# cc3d's voxel_connectivity_graph bit for each of the 26 moves: bit
# GRAPH_BITS[o] at v is set where the move from v to v + o is open
GRAPH_BITS = {
    (1, 0, 0): 0, (-1, 0, 0): 1, (0, 1, 0): 2, (0, -1, 0): 3,
    (0, 0, 1): 4, (0, 0, -1): 5,
    (1, 1, 0): 6, (-1, 1, 0): 7, (1, -1, 0): 8, (-1, -1, 0): 9,
    (1, 0, 1): 10, (-1, 0, 1): 11, (0, 1, 1): 12, (0, -1, 1): 13,
    (1, 0, -1): 14, (-1, 0, -1): 15, (0, 1, -1): 16, (0, -1, -1): 17,
    (1, 1, 1): 18, (-1, 1, 1): 19, (1, -1, 1): 20, (-1, -1, 1): 21,
    (1, 1, -1): 22, (-1, 1, -1): 23, (1, -1, -1): 24, (-1, -1, -1): 25,
}


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def pair_slices(o, shape):
    """(dst, src) slices: v in dst, v + o in src."""
    dst = tuple(slice(max(-c, 0), n + min(-c, 0)) for c, n in zip(o, shape))
    src = tuple(slice(max(c, 0), n + min(c, 0)) for c, n in zip(o, shape))
    return dst, src


def label_graph(pre: torch.Tensor) -> torch.Tensor:
    """cc3d's voxel connectivity graph of a label volume (int32 words): the
    move from v along o is open where v + o is inside and has v's label."""
    vg = torch.zeros(pre.shape, dtype=torch.int32, device=pre.device)
    for o, bit in GRAPH_BITS.items():
        dst, src = pair_slices(o, pre.shape)
        vg[dst] |= (pre[dst] == pre[src]).to(torch.int32) << bit
    return vg


def base_volume(config: dict, traffic: dict, device):
    """(base labels (int32 on `device`), voxel graph (host uint32) or
    None) of a cell: the traffic's steps in order."""
    shape = [int(x) for x in config["chunk"]]
    vol, graph = None, None
    for step in traffic["steps"]:
        kind = step["step"]
        if not re.fullmatch(r"[A-Za-z0-9_]+", kind):
            raise ValueError(f"bad step name {kind!r}")
        mod = importlib.import_module(f"steps.{kind}")
        vol, graph = mod.apply(vol, graph, step, shape, device)
    return vol.contiguous(), graph


class Chunks:
    """The chunks of one run: the base volume under a fresh permutation of
    its nonzero ids each, drawn from the run's seed."""

    def __init__(self, base: torch.Tensor, seed: int):
        self.base = base
        self.n_ids = int(base.max()) + 1
        self._gen = generator(base.device, seed)

    def next(self):
        """(the chunk as a host uint32 array, the id table (host int64):
        chunk = table[base])."""
        perm = torch.randperm(self.n_ids - 1, generator=self._gen,
                              device=self.base.device) + 1
        lut = torch.cat([torch.zeros(1, dtype=perm.dtype,
                                     device=perm.device), perm])
        chunk = lut.to(torch.int32)[self.base.long()]
        return chunk.cpu().numpy().view(np.uint32), lut.cpu().numpy()

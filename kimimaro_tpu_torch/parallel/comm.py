"""The exchanges between shards, in one place.

The multi-device path runs in ONE process over a list of devices (a
`Mesh`): each shard of a volume is a tensor on its own device, and every
`shard_map` body of the JAX package becomes a loop over the shards. What
the JAX package does with collectives over the mesh axis becomes an
explicit copy or reduction here:

  ppermute   -> `ring_shift` (a block to the next shard, wrapping) and
                `halos` (each shard's edge planes to its neighbours, with
                a fill plane at the mesh's ends);
  psum/pmax/pmin -> `psum`, `pmax`, `pmin` of per-shard tensors, the
                result on the mesh's home device;
  all_gather -> `all_gather` (per-shard tensors stacked on the home
                device) and `all_gather_cat` (per-shard tensors of any
                lengths, concatenated there).

A region read off the slabs (a crop, or a batch of crops) is
`gather_crop`: the pieces the shards hold, copied to the home device.
Each call adds one to its entry in `EXCHANGES`; `fetch` is the one
device-to-host copy of the multi-device path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

# exchanges since the last reset, by collective of the JAX package
EXCHANGES: Dict[str, int] = {
    "ppermute": 0, "psum": 0, "pmax": 0, "pmin": 0, "all_gather": 0,
    "crop": 0, "fetch": 0,
}


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


class Mesh:
    """An ordered tuple of devices, one per shard; shard i holds rows
    [i*h, (i+1)*h) of a volume's leading axis. Devices may repeat (shards
    sharing a card). The first device is the home of replicated state."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh(shard: {', '.join(str(d) for d in self.devices)})"


def ring_shift(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """ppermute i -> i + 1 (mod n): shard i receives shard i-1's block."""
    EXCHANGES["ppermute"] += 1
    n = len(xs)
    return [xs[(i - 1) % n].to(mesh.devices[i]) for i in range(n)]


def halos(first: List[torch.Tensor], last: List[torch.Tensor], mesh: Mesh,
          fill) -> tuple:
    """The two ppermutes of a halo exchange: (from_prev, from_next) per
    shard, from_prev[i] = shard i-1's last plane and from_next[i] = shard
    i+1's first plane; the ends of the mesh get `fill` planes (no
    wrap)."""
    EXCHANGES["ppermute"] += 2
    n = len(first)
    prev, nxt = [], []
    for i in range(n):
        dev = mesh.devices[i]
        prev.append(torch.full_like(last[i], fill) if i == 0
                    else last[i - 1].to(dev))
        nxt.append(torch.full_like(first[i], fill) if i == n - 1
                   else first[i + 1].to(dev))
    return prev, nxt


def _home(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    return [x.to(mesh.home) for x in xs]


def psum(xs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of per-shard tensors, on the home device (in shard order)."""
    EXCHANGES["psum"] += 1
    out = None
    for x in _home(xs, mesh):
        out = x.clone() if out is None else out + x
    return out


def pmax(xs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    EXCHANGES["pmax"] += 1
    return torch.stack(_home(xs, mesh)).amax(dim=0)


def pmin(xs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    EXCHANGES["pmin"] += 1
    return torch.stack(_home(xs, mesh)).amin(dim=0)


def any_changed(flags: List[torch.Tensor], mesh: Mesh) -> bool:
    """The psum'd changed-flag of a fixpoint loop, read on the host."""
    return bool(fetch(psum([f.to(torch.int32) for f in flags], mesh)) > 0)


def all_gather(xs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard tensors stacked along a new leading axis on the home
    device."""
    EXCHANGES["all_gather"] += 1
    return torch.stack(_home(xs, mesh))


def all_gather_cat(xs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard tensors of any leading lengths, concatenated in shard
    order on the home device (a ragged all_gather)."""
    EXCHANGES["all_gather"] += 1
    return torch.cat(_home(xs, mesh))


def gather_crop(pieces: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """One region read off the slabs (a crop, or one batch of crops): the
    pieces the shards hold, each copied to the home device."""
    EXCHANGES["crop"] += 1
    return _home(pieces, mesh)


def fetch(x: Optional[torch.Tensor]):
    """The device-to-host copy of the multi-device path: a numpy array."""
    EXCHANGES["fetch"] += 1
    return None if x is None else x.detach().to("cpu").numpy()


"""Halo exchange for maps sharded by row bands over a mesh.

Counterpart of the JAX package's ``parallel/halo.py``: a whole map cut
into row bands, one a shard; a stencil at a band's border needs its
neighbours' edge rows. JAX swaps them with ``lax.ppermute`` inside
``shard_map``; here each band takes ``halo`` rows from the bands before and
after it by a copy to its device. At the ends of the mesh a band repeats
its own edge row, as JAX's does.
"""

from __future__ import annotations

from typing import Callable

import torch

from path_gene_multimodal_tpu_torch.parallel.mesh import Mesh, gather, on_device, shard_batch


def exchange_halo(bands: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Row bands (rows, cols[, c]), each on its shard's device, in mesh
    order → each band extended by ``halo`` rows of the previous and the
    next band (its own first / last row repeated at the mesh's ends)."""
    if halo == 0:
        return list(bands)  # x[-0:] would be the whole band
    if any(b.shape[0] < halo for b in bands):
        raise ValueError(f"a band has fewer than halo={halo} rows")
    n = len(bands)
    out = []
    for i, x in enumerate(bands):
        dev = x.device
        prev = (bands[i - 1][-halo:].to(dev, non_blocking=True) if i > 0
                else x[:1].expand(halo, *x.shape[1:]))
        nxt = (bands[i + 1][:halo].to(dev, non_blocking=True) if i < n - 1
               else x[-1:].expand(halo, *x.shape[1:]))
        out.append(torch.cat([prev, x, nxt], dim=0))
    return out


def sharded_stencil(fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh, halo: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A stencil ``fn(band with halo) -> same shape`` as a whole-map op over
    the mesh: cut the rows into bands, exchange halos, apply ``fn`` on each
    band's device, crop the halo, and gather the map on the mesh's first
    device."""

    def run(x: torch.Tensor) -> torch.Tensor:
        bands = exchange_halo(shard_batch(x, mesh), halo)
        outs = []
        for band in bands:
            with on_device(band.device):
                out = fn(band)
                outs.append(out[halo:-halo] if halo else out)  # out[0:-0] is empty
        return gather(outs, mesh.devices[0])

    return run

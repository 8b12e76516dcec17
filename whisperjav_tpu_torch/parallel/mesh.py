"""The data-parallel device mesh of window batches.

Counterpart of ``whisperjav_tpu/parallel/mesh.py`` for inference: one
mesh axis, ``data``, over the first N visible cards. A batch's rows split
into contiguous equal blocks, one per device, as ``P("data")`` shards the
leading axis in the JAX package. Inference needs no collective: each
device decodes its own rows and the host gathers the results
(``pipelines/engine.py``).

The mesh is opt-in (``--devices N``), where the JAX factory shards over
every device by default: the engine drives its shards from host threads
of one process, and the decode step is host-bound, so two shards take
longer than one card alone (PERF.md §6).

Where no CUDA card is visible the mesh is one CPU device. ``devices``
names the devices outright (two CPU replicas, or ``cuda:0`` twice): a
hook for tests and the on-card smoke run, which the command line does
not expose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from whisperjav_tpu_torch.utils.logger import logger


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the one axis, ``data``."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, rows: int) -> List[slice]:
        """The contiguous equal row blocks of a ``rows``-row batch, one
        per device in order."""
        per, rem = divmod(rows, self.size)
        if rem:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{self.size} devices")
        return [slice(k * per, (k + 1) * per) for k in range(self.size)]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (default: every
    visible one), one CPU device where none is visible, or over
    ``devices`` as given."""
    if devices is None:
        if torch.cuda.is_available():
            count = torch.cuda.device_count()
            n = count if n_devices is None else min(n_devices, count)
            devices = [f"cuda:{i}" for i in range(n)]
        else:
            devices = ["cpu"]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(torch.device(d) for d in devices))


class DevicesConflict(ValueError):
    """``--devices`` above 1 together with a card named by its index."""


def mesh_for(device, devices: Optional[int]) -> Optional[Mesh]:
    """The mesh ``build_pipeline`` shards over: the first ``devices``
    visible cards, capped at the cards there are, as the JAX factory
    takes them. None (one device) by default, for ``devices == 1``, on
    the CPU, for a CUDA device named by its index, or where one card is
    visible. Asking for more than one device together with an indexed
    CUDA device raises DevicesConflict."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None and (devices or 0) > 1:
        raise DevicesConflict(
            f"--devices {devices} shards over the first cards, which "
            f"--device {device} (one card by its index) rules out; pass "
            "--device cuda")
    if dev.type != "cuda" or dev.index is not None or (devices or 0) <= 1:
        return None
    n = min(devices, torch.cuda.device_count())
    return make_mesh(n) if n > 1 else None


def padded_batch(batch_size: int, n_devices: int) -> int:
    """The global batch rounded up to a multiple of the mesh size (so
    the row blocks are equal), with the JAX factory's log line."""
    if batch_size % n_devices:
        padded = -(-batch_size // n_devices) * n_devices
        logger.info("data-parallel mesh over %d devices: global batch "
                    "%d → %d", n_devices, batch_size, padded)
        return padded
    logger.info("data-parallel mesh over %d devices (global batch %d)",
                n_devices, batch_size)
    return batch_size

"""Multi-host batch jobs: the file set split across processes.

Counterpart of ``whisperjav_tpu/parallel/multihost.py``. Across hosts
the unit of work is the file: decode, scenes and VAD are host-local and
each process transcribes its own slice of the discovered files with its
own GPU, so the processes share only a control plane
(``torch.distributed`` over gloo) and no tensors. Outputs land in a
shared directory; ``--skip-existing`` makes a re-run after a host
failure do only what is missing.

    whisperjav-torch /data --multihost \\
        --coordinator host0:8476 --num-hosts 4 --host-id $ID

Unlike the JAX package (``multihost.py:54-57``), a rendezvous that fails
raises: a process never falls back to doing every file alone.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist

from whisperjav_tpu_torch.utils.logger import logger


def initialize_distributed(coordinator: Optional[str] = None,
                           num_hosts: Optional[int] = None,
                           host_id: Optional[int] = None,
                           timeout_s: Optional[float] = None
                           ) -> Tuple[int, int]:
    """Join the control plane (idempotent) and return (rank, world).

    ``coordinator`` ("host:port", served by process 0) with ``num_hosts``
    and ``host_id`` names the rendezvous; without it the environment may
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` as
    ``torchrun`` sets them). With neither, or a world of one, the process
    runs alone: (0, 1). A rendezvous that was asked for and does not
    complete within ``timeout_s`` (default ``$WJAV_RENDEZVOUS_TIMEOUT_S``,
    300) raises ``RuntimeError``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if timeout_s is None:
        timeout_s = float(os.environ.get("WJAV_RENDEZVOUS_TIMEOUT_S",
                                         "300"))
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator:
        if num_hosts is None or host_id is None:
            raise ValueError("--coordinator needs --num-hosts and --host-id")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"--host-id {host_id} outside "
                             f"0..{num_hosts - 1}")
        if num_hosts == 1:
            return 0, 1
        kwargs = dict(init_method=f"tcp://{coordinator}",
                      world_size=num_hosts, rank=host_id)
        where = coordinator
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        kwargs = dict(init_method="env://")
        where = (f"{os.environ.get('MASTER_ADDR')}:"
                 f"{os.environ.get('MASTER_PORT')}")
    else:
        return 0, 1
    try:
        dist.init_process_group(backend="gloo", timeout=timeout, **kwargs)
    except Exception as e:  # noqa: BLE001 — re-raised with the cause
        raise RuntimeError(f"multihost rendezvous at {where} failed: "
                           f"{e}") from e
    rank, world = dist.get_rank(), dist.get_world_size()
    logger.info("multihost: process %d of %d joined %s", rank, world, where)
    return rank, world


def shard_files(files: Sequence, process_index: int,
                process_count: int) -> List:
    """Deterministic per-host slice of the file list.

    When every file's duration is known (media probing fills
    MediaInfo.duration), assignment is greedy longest-processing-time:
    files sort by (duration desc, name) and each goes to the host with
    the smallest summed duration so far — balancing *audio hours*, not
    file counts (a directory mixing 10-min clips with 3-hour features
    leaves round-robin hosts idle for hours). Without full duration
    info it falls back to round-robin by sorted name, which still mixes
    sizes reasonably (directories often sort small-to-large by
    episode). Both schemes are pure functions of the file set, so the
    assignment is stable across re-runs for --skip-existing resume.
    """
    if process_count <= 1:
        return list(files)

    def _name(m) -> str:
        return str(getattr(m, "path", m))

    durations = [getattr(m, "duration", None) for m in files]
    if files and all(isinstance(d, (int, float)) and d > 0
                     for d in durations):
        order = sorted(files,
                       key=lambda m: (-float(m.duration), _name(m)))
        loads = [0.0] * process_count
        mine: List = []
        for m in order:
            # ties (equal loads) break toward the lowest host id —
            # deterministic for resume
            host = min(range(process_count), key=lambda h: (loads[h], h))
            loads[host] += float(m.duration)
            if host == process_index:
                mine.append(m)
        mine.sort(key=_name)
        logger.info(
            "multihost: process %d/%d takes %d/%d file(s), %.0f/%.0f "
            "audio-seconds (duration-balanced)", process_index,
            process_count, len(mine), len(files),
            loads[process_index], sum(loads))
        return mine

    ordered = sorted(files, key=_name)
    mine = ordered[process_index::process_count]
    logger.info("multihost: process %d/%d takes %d/%d file(s)",
                process_index, process_count, len(mine), len(ordered))
    return mine

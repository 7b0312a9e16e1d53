"""Multi-process bring-up (SURVEY §2.5 obligation).

The reference has no inter-process anything; here jax.distributed
process groups + a global mesh whose 'dp' axis spans processes (members
assigned per process, outputs gathered in stream order), with checksum
combines riding the same collectives as the single-process path
(parallel/shard.py works unchanged on a global mesh; XLA hands shard_map's
all_gather to the platform's collectives, NCCL on GPUs).

The multi-process path runs as local processes on virtual CPU devices
(tests/test_multihost.py); one process drives all GPUs of one host.
jax.distributed needs its coordinator address, process count and id
given explicitly.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up jax.distributed (no-op if single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(dp: int | None = None, sp: int = 1) -> Mesh:
    """Mesh over ALL processes' devices: dp spans processes, then each
    process's devices; sp stays within a process's devices so
    sequence-parallel gathers stay on the host's own interconnect."""
    devs = np.array(jax.devices())
    n = devs.size
    if dp is None:
        dp = n // sp
    assert dp * sp == n
    return Mesh(devs.reshape(dp, sp), ("dp", "sp"))


def assign_members(sizes: list[int], n_shards: int) -> list[list[int]]:
    """Greedy balanced assignment of streams to shards by compressed
    size (longest-processing-time heuristic) — keeps per-host decode
    time even."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    loads = [0] * n_shards
    out: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        k = loads.index(min(loads))
        out[k].append(i)
        loads[k] += sizes[i]
    return out

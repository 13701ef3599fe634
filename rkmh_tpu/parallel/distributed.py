"""Multi-host execution: jax.distributed + per-host read sharding.

The reference is a single OpenMP process (SURVEY.md §2.4 — no MPI/NCCL/
anything).  Here multi-host scaling is the standard JAX recipe:

1. every host calls :func:`initialize` (coordinator address via env or
   args) — NVLink collectives inside a host, the network across hosts;
2. the global mesh spans all devices; reads are sharded by host
   (:func:`host_read_shard` gives each host its contiguous slice of the
   input, zero cross-host IO at read time);
3. the classify step is the same shard_map program as single-host
   (parallel/mesh.py) — counts merge with all_gather over tp, reads stay
   dp-local, so the only cross-host traffic is the panel broadcast at
   startup (a few MB) and per-batch result lines written host-locally.

Output ordering: each host writes its own shard's lines (classification
output is per-read and order-free across shards; the reference's own
multithreaded output order is nondeterministic, SURVEY.md §8 Q10).

There is no multi-host hardware in CI; host_read_shard and mesh-building
logic are tested with virtual CPU devices, and initialize() is the
documented thin wrapper over jax.distributed.initialize.
"""

from __future__ import annotations

import os

import numpy as np
import jax


_LOOPBACK = ("localhost", "127.0.0.1", "::1", "[::1]")


def _same_host(coordinator_address: str | None) -> bool:
    """True when the coordinator is on this machine, i.e. every rank
    shares this host (the --dist-procs N launch on one multi-GPU box)."""
    if not coordinator_address:
        return False
    host = coordinator_address.rsplit(":", 1)[0]
    return host in _LOOPBACK or host.startswith("127.")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op when single-process).

    Defaults come from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID).  Ranks that share one host (a
    loopback coordinator) each take the card of their own rank, so no
    rank reserves memory on another rank's card; JAX_LOCAL_DEVICE_IDS
    overrides that choice.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        return  # single-process: nothing to do
    local_device_ids = None
    if (process_id is not None and not os.environ.get("JAX_LOCAL_DEVICE_IDS")
            and _same_host(coordinator_address)):
        local_device_ids = [process_id]
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def host_read_shard(n_records: int,
                    process_id: int | None = None,
                    num_processes: int | None = None) -> tuple[int, int]:
    """[start, stop) slice of the input this host should parse+classify.

    Contiguous block partition (remainder spread over the first hosts) so
    each host streams its own file region — pure data parallelism over
    reads, the same decomposition rkmh's `#pragma omp for` applies to its
    read loop (rkmh.cpp:845), lifted to hosts.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    base, rem = divmod(n_records, n)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return start, stop


def global_mesh(dp: int | None = None, tp: int = 1):
    """Mesh over every device of every host (dp x tp), dp defaulting to
    all-devices/tp.  Use with parallel.mesh.sharded_classify_table_fn."""
    from rkmh_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices(), dp=dp, tp=tp)

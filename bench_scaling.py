"""Scaling-efficiency harness: classify throughput at dp = 1, 2, 4, ... N.

Runs the production sharded classify step (parallel/mesh.py, bucket-table
fast path) over meshes of increasing size and reports per-device
efficiency vs the 1-device run.  On real multi-chip hardware this
measures ICI scaling; in CI it runs on the virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
and validates that the dp decomposition itself adds no overhead.

Prints one JSON line per mesh size:
  {"devices": d, "reads_per_sec": r, "efficiency": r / (d * r_1)}
"""

import json
import time

import numpy as np


def main():
    import rkmh_tpu  # noqa: F401
    import jax

    from rkmh_tpu.classify import engine
    from rkmh_tpu.commands.common import build_ref_panel, load_packed
    from rkmh_tpu.parallel.mesh import (
        build_sharded_tables,
        make_mesh,
        sharded_classify_table_fn,
    )

    DATA = "/root/reference/data"
    ks, s = (12,), 1000
    from rkmh_tpu.utils import to_host

    reads = load_packed(f"{DATA}/z1.fq", granularity=32)
    panel = build_ref_panel(load_packed(f"{DATA}/zika.refs.fa"), ks, s)
    sk_np, lens_np = to_host((panel.sketches, panel.lens))
    tables, rps = build_sharded_tables(sk_np, lens_np, tp=1)

    n_dev = len(jax.devices())
    platform = jax.devices()[0].platform
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    per_dev_batch = 2048 if platform != "cpu" else 256
    base_rate = None
    if platform == "cpu" and n_dev > 1:
        print(json.dumps({
            "note": "virtual CPU devices share physical cores: total "
                    "throughput stays flat by construction; efficiency "
                    "numbers are only meaningful on real multi-chip hardware"
        }))

    for d in sizes:
        mesh = make_mesh(jax.devices()[:d], dp=d, tp=1)
        step = sharded_classify_table_fn(mesh, ks, s, rps)
        batch = per_dev_batch * d
        reps = int(np.ceil(batch / len(reads)))
        codes = np.tile(reads.codes, (reps, 1))[:batch]
        out = step(codes, tables)
        jax.block_until_ready(out)

        iters = 5
        t0 = time.perf_counter()
        outs = [step(codes, tables) for _ in range(iters)]
        jax.block_until_ready(outs[-1])
        dt = time.perf_counter() - t0
        rate = batch * iters / dt
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "devices": d,
            "reads_per_sec": round(rate, 1),
            "per_device": round(rate / d, 1),
            "efficiency": round(rate / (d * base_rate), 3),
        }))


if __name__ == "__main__":
    main()

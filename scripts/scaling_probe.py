#!/usr/bin/env python
"""Scaling-efficiency helper: decode_streams_sharded WEAK scaling on an
n-virtual-device CPU mesh — per-device work is fixed (4 streams of
per_dev/4 bytes each per device), so ideal scaling is constant wall
time and efficiency_n = t_1 / t_n. Strong scaling is meaningless here:
virtual devices share the host's physical cores, so adding devices
cannot shrink wall time; weak scaling still exposes any serialization
in the sharded-decode path (bucketing, shard_map dispatch, ordered
gather), which is the part that transfers to a real multi-chip slice.

Calibration: a PURE fixed-work-per-device jit (elementwise fori, no
host stages) measures t_1/t_4 ~= 0.75 on this platform (2026-08-17,
taskset n cores for n devices) — the virtual-CPU mesh's own dispatch
overhead caps the curve well below 1.0, so decode efficiencies should
be read against that ceiling, not against 1.0.

Run as a subprocess by bench.py (one process per device count — XLA's
host device count is fixed at startup). Prints ONE JSON line
{"n_dev": N, "t": seconds, "gbps": X} on stdout; detail to stderr.
It runs on the CPU platform only, so it never opens an accelerator
that another process holds.
"""
import json
import os
import sys
import time
import zlib

n_dev = int(sys.argv[1])
per_dev = int(sys.argv[2]) if len(sys.argv) > 2 else 2 << 20
mode = sys.argv[3] if len(sys.argv) > 3 else "decode"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           f" --xla_force_host_platform_device_count={n_dev}")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from bench import make_corpus  # noqa: E402
from tbz.parallel import shard  # noqa: E402
from tbz.parallel.mesh import make_mesh  # noqa: E402


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def control():
    """Pure fixed-work-per-device jit (elementwise fori over a sharded
    array, no host stages, no collectives): the virtual-CPU platform's
    OWN weak-scaling ceiling. Decode efficiency is read against this."""
    import functools
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import numpy as np
    mesh = Mesh(np.array(jax.devices()), ("d",))
    sh = NamedSharding(mesh, P("d"))
    n = (per_dev // 4) * n_dev  # int32 words, fixed per device
    x = jax.device_put(jnp.arange(n, dtype=jnp.int32), sh)

    # ~100ms/point: comparable wall time to the decode points, so the
    # ceiling reflects the same dispatch-overhead-to-work ratio
    @functools.partial(jax.jit, donate_argnums=())
    def work(a, salt):
        def body(i, v):
            return v * 1103515245 + i + salt
        return jax.lax.fori_loop(0, 4800, body, a)

    ts = []
    for it in range(6):
        t0 = time.perf_counter()
        jax.block_until_ready(work(x, jnp.int32(it)))
        dt = time.perf_counter() - t0
        if it:
            ts.append(dt)
    print(json.dumps({"n_dev": n_dev, "t": _median(ts), "reps": ts}))


def main():
    if mode == "control":
        control()
        return
    size = per_dev * n_dev
    data = make_corpus(size)
    n_streams = 4 * n_dev
    chunk = -(-len(data) // n_streams)
    pieces = [data[i * chunk:(i + 1) * chunk] for i in range(n_streams)]
    payloads = [zlib.compress(p, 6) for p in pieces]
    mesh = make_mesh(n_devices=n_dev, sp=1)
    ts = []
    for it in range(4):
        t0 = time.perf_counter()
        outs = shard.decode_streams_sharded(payloads, mesh, format="zlib")
        dt = time.perf_counter() - t0
        if it:  # first iteration pays compiles
            ts.append(dt)
    assert b"".join(outs) == data, "sharded decode mismatch"
    t = _median(ts)
    print(json.dumps({"n_dev": n_dev, "t": t, "reps": ts,
                      "gbps": size / t / 1e9}))


if __name__ == "__main__":
    main()

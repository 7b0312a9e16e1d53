"""Multi-process bring-up: 2 local processes x 2 virtual CPU devices
form a 4-device global mesh via jax.distributed; sharded checksums and a
dp-sharded decode run across process boundaries (SURVEY §2.5 — the
multi-host path exercised as N local processes)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys, zlib
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
repo = sys.argv[4]
sys.path.insert(0, repo)

from tbz.parallel import distributed, shard

distributed.initialize(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc, jax.device_count()
mesh = distributed.global_mesh(dp=2 * nproc)

# --- sequence-sharded checksums over a process-spanning global array ---
from jax.sharding import NamedSharding, PartitionSpec as P
N = 2 * nproc * 8192
data = (b"multihost-corpus-" * 4096)[: N - 777]
arr = np.zeros(N, np.uint8)
arr[: len(data)] = np.frombuffer(data, np.uint8)
sharding = NamedSharding(mesh, P("dp"))
garr = jax.make_array_from_callback(arr.shape, sharding,
                                    lambda idx: arr[idx])
crc_fn = shard.make_sharded_crc32(mesh, N)
adler_fn = shard.make_sharded_adler32(mesh, N)
assert int(crc_fn(garr, np.uint32(len(data)))) == zlib.crc32(data)
assert int(adler_fn(garr, np.uint32(len(data)))) == zlib.adler32(data)

# --- dp-sharded member decode across processes -------------------------
# Every process feeds identical host data; the resolve batch is sharded
# over the global dp axis so each process computes its local quarter.
import functools
import jax.numpy as jnp
from tbz import frontend
from tbz.ops import resolve as R

streams = [bytes([65 + i]) * (4000 + 101 * i) + b"-tail" for i in
           range(2 * nproc)]
payloads = [zlib.compress(s, 6)[2:-4] for s in streams]
metas = [frontend.tokenize(p) for p in payloads]
T = max(1024, 1 << (max(len(m.tape) for m in metas) - 1).bit_length())
cap = max(4096, 1 << (max(m.tape.total_out for m in metas) - 1).bit_length())
M = max(1024, 1 << (max(len(p) for p in payloads) - 1).bit_length())
S = len(metas)
out_len = np.zeros((S, T), np.int32); dist = np.zeros((S, T), np.int32)
root_val = np.zeros((S, T), np.int32)
n_tokens = np.zeros(S, np.int32); total_out = np.zeros(S, np.int32)
inputs = np.zeros((S, M), np.uint8); windows = np.zeros((S, R.W), np.uint8)
for i, (m, p) in enumerate(zip(metas, payloads)):
    t = m.tape; n = len(t)
    out_len[i, :n] = t.out_len; dist[i, :n] = t.dist
    root_val[i, :n] = t.root_val
    n_tokens[i] = n; total_out[i] = t.total_out
    inputs[i, :len(p)] = np.frombuffer(p, np.uint8)

def gput(x):
    spec = P("dp", *([None] * (x.ndim - 1)))
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

# _resolve_batch returns body rows only (window prefix stripped in-jit)
out = shard._resolve_batch(gput(out_len), gput(dist), gput(root_val),
                           gput(n_tokens), gput(total_out), gput(inputs),
                           gput(windows), cap)
# each process checks its addressable shards byte-exactly
for js in out.addressable_shards:
    si0 = js.index[0].start or 0
    local = np.asarray(js.data)
    for k in range(local.shape[0]):
        si = si0 + k
        got = local[k, :total_out[si]].tobytes()
        assert got == streams[si], f"stream {si} mismatch on pid {pid}"
print(f"MULTIHOST-OK pid={pid}", flush=True)
"""


def test_two_process_mesh(tmp_path):
    nproc = 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(nproc), str(port), repo],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(nproc)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST-OK pid={pid}" in out

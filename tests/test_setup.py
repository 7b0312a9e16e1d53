"""Set-up the device path depends on: where the compile cache lives, and
that the native library is rebuilt unless its stamp matches."""

import os
import subprocess
import sys

import pytest

from tbz.native import loader
from tbz.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, sys
from tbz.utils import compile_cache
d = compile_cache.enable()
assert jax.config.jax_compilation_cache_dir == d, (d, jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
print(d)
"""


@pytest.mark.parametrize("var_set", [True, False])
def test_compile_cache_placement(tmp_path, var_set):
    """With JAX_COMPILATION_CACHE_DIR set the cache is written there and
    nowhere else; unset, it is the fixed <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if var_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        want = str(tmp_path / "cache")
    else:
        want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    before = (set(os.listdir(compile_cache.DEFAULT_DIR))
              if os.path.isdir(compile_cache.DEFAULT_DIR) else set())
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    assert os.listdir(want), "nothing was cached"
    if var_set:
        after = (set(os.listdir(compile_cache.DEFAULT_DIR))
                 if os.path.isdir(compile_cache.DEFAULT_DIR) else set())
        assert after == before, "cache written outside the named dir"


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library whose stamp does not match this source, command and
    compiler (say, one built on another machine) is rebuilt; a matching
    one is reused."""
    src = tmp_path / "lib.cc"
    src.write_text('extern "C" int tbz_probe() { return 7; }\n')
    so = tmp_path / "build" / "libtbz.so"
    monkeypatch.setattr(loader, "_SRC", str(src))
    monkeypatch.setattr(loader, "_BUILD_DIR", str(so.parent))
    monkeypatch.setattr(loader, "_SO", str(so))
    so.parent.mkdir()
    so.write_bytes(b"not a library")
    (tmp_path / "build" / "libtbz.so.stamp").write_text("stale")
    os.utime(so, (2**31, 2**31))  # newer than the source: mtime says keep

    assert loader._build() == str(so)
    import ctypes
    assert ctypes.CDLL(str(so)).tbz_probe() == 7
    mtime = so.stat().st_mtime_ns
    assert loader._build() == str(so)   # stamp matches: reused as is
    assert so.stat().st_mtime_ns == mtime

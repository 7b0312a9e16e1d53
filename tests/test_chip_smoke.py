"""chip_smoke.py's phases: at tiny sizes on the CPU backend here, at the
sizes `python chip_smoke.py` uses on an NVIDIA GPU (`gpu` marker)."""

import gzip
import random
import struct

import jax
import pytest

import chip_smoke as CS
from tbz.native import loader

pytestmark = pytest.mark.skipif(not loader.available(),
                                reason="native scanner required")

# phase name -> (tiny-size call on given devices, real-size call)
PHASES = {
    "A_fused_gzip": (lambda d: CS.phase_a_fused_gzip(300_000, d[0]),
                     lambda d: CS.phase_a_fused_gzip(200_000_000, d[0])),
    "B_zlib_adler": (lambda d: CS.phase_b_zlib_adler(200_000, d[0]),
                     lambda d: CS.phase_b_zlib_adler(16_000_000, d[0])),
    "C_span_resolver": (
        lambda d: CS.phase_c_span_resolver(48 << 10, 100_000, 2048, d[0]),
        lambda d: CS.phase_c_span_resolver(48 << 10, 4_000_000, 8 << 10,
                                           d[0])),
    "D_sharded_1dev": (lambda d: CS.phase_d_sharded(8, 4096, d[:1]),
                       lambda d: CS.phase_d_sharded(1024, CS.BGZF_BLOCK,
                                                    d[:1])),
}
FOUR = {
    "sharded_4dev": lambda d: CS.phase_d_sharded(12, 4096, d[:4]),
    "sharded_checksums_4dev": lambda d: CS.phase_sharded_checksums(
        1 << 16, d[:4]),
}


@pytest.mark.parametrize("phase", list(PHASES) + list(FOUR))
def test_phase_tiny_cpu(phase):
    devs = jax.devices()
    if phase in FOUR:
        assert len(devs) >= 4  # conftest gives 8 virtual CPU devices
        FOUR[phase](devs)
    else:
        PHASES[phase][0](devs)


def test_bgzf_member_shape():
    data = CS.corpus(CS.BGZF_BLOCK)
    m = CS.bgzf_member(data)
    assert gzip.decompress(m) == data
    # FEXTRA with the 'BC' subfield; BSIZE = total block size - 1
    assert m[3] == 4 and m[12:14] == b"BC"
    assert struct.unpack("<H", m[16:18])[0] == len(m) - 1
    # incompressible data still fits: stored blocks at htslib's size
    rnd = random.Random(0).randbytes(CS.BGZF_BLOCK)
    assert len(CS.bgzf_member(rnd)) <= 1 << 16


@pytest.mark.gpu
@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_real_size_gpu(gpu_device, phase):
    PHASES[phase][1]([gpu_device])

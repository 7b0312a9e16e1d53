"""tbz — a DEFLATE codec that inflates into accelerator memory.

Built from scratch in JAX/XLA/Pallas with the behavioral contract of the
3b/3bz reference decompressor (see SURVEY.md): byte-exact inflate of raw
DEFLATE / zlib / gzip streams, block-granular streaming, a matching
encoder, and data-parallel multi-chip/multi-host decode.

Package layout (the "models/ops/parallel/utils" template mapped onto a
codec):
  constants, huffman, errors    — tables & spec core (reference L1/L3)
  bitreader, reference, frontend — host frontends (reference L2/L4)
  ops/                          — device kernels: resolver, tokenizer,
                                  checksum kernels (reference's hot loops)
  checksums                     — Adler-32 / CRC-32 + parallel combines
  formats/                      — zlib / gzip framing (reference L5)
  api, streaming                — one-shot + chunked APIs (reference L6)
  deflate_encode, lz77, huffman_encode — the encoder (beyond reference)
  parallel/                     — mesh / shard_map distribution
  native/                       — C++ runtime components (ctypes)
  zlib_compat                   — stdlib-zlib drop-in surface
                                  (compressobj/decompressobj, wbits,
                                  zdict, copy; one-import migration)
  gzip_compat                   — stdlib-gzip drop-in surface
  index                         — random access via checkpoint index

CLI: `python -m tbz [-d] [-c] [-l N] file` (gzip-compatible tool).
"""

from .errors import ChecksumError, DeflateError, TruncatedError

__version__ = "0.1.0"

__all__ = [
    "DeflateError", "ChecksumError", "TruncatedError",
    "decompress", "compress", "decompress_into", "decompress_file",
    "decompress_stream",
    "Decompressor", "Compressor", "ZipReader", "ZipWriter",
]


def __getattr__(name):
    # Lazy so that `import tbz` works without jax for host-only tools.
    if name in ("decompress", "compress", "decompress_into",
                "decompress_file", "decompress_stream"):
        from . import api
        return getattr(api, name)
    if name in ("Decompressor", "Compressor"):
        from . import streaming
        return getattr(streaming, name)
    if name in ("ZipReader", "ZipWriter"):
        from .formats import zip_fmt
        return getattr(zip_fmt, name)
    raise AttributeError(name)

"""Command-line entry: `python -m tbz` — a minimal gzip-compatible
tool over the tbz codec (compress/decompress files or stdio).

Examples:
  python -m tbz -c file > file.gz       # compress to stdout
  python -m tbz -d file.gz              # -> file (strips .gz)
  python -m tbz -d -c file.gz > file    # decompress to stdout
  python -m tbz --bench file            # time decode of a .gz/.zlib
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tbz",
        description="tbz DEFLATE codec CLI (gzip framing)")
    ap.add_argument("file", nargs="?", help="input file (default stdin)")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("-c", "--stdout", action="store_true",
                    help="write to stdout instead of a sibling file")
    ap.add_argument("-l", "--level", type=int, default=6,
                    help="compression level 0-9 (default 6)")
    ap.add_argument("-f", "--format", default="auto",
                    choices=["auto", "gzip", "zlib", "raw"])
    ap.add_argument("--threads", type=int, default=0,
                    help="segment-parallel encode threads (0 = serial)")
    ap.add_argument("--bench", action="store_true",
                    help="time the operation and report MB/s to stderr")
    args = ap.parse_args(argv)

    from . import api

    if args.file and args.file != "-":
        with open(args.file, "rb") as f:
            data = f.read()
    else:
        data = sys.stdin.buffer.read()

    t0 = time.perf_counter()
    if args.decompress:
        fmt = args.format
        out = api.decompress(data, format=fmt)
        default_name = (args.file[:-3] if args.file
                        and args.file.endswith(".gz") else None)
    else:
        fmt = "gzip" if args.format == "auto" else args.format
        name = os.path.basename(args.file) if args.file else None
        out = api.compress(data, format=fmt, level=args.level,
                           name=name if fmt == "gzip" else None,
                           threads=args.threads or None)
        default_name = (args.file + ".gz") if args.file else None
    dt = time.perf_counter() - t0

    if args.bench:
        n = len(out) if args.decompress else len(data)
        print(f"[tbz] {n / max(dt, 1e-9) / 1e6:.1f} MB/s "
              f"({len(data)} -> {len(out)} bytes, {dt * 1e3:.0f} ms)",
              file=sys.stderr)

    if args.stdout or not default_name:
        sys.stdout.buffer.write(out)
    else:
        with open(default_name, "wb") as f:
            f.write(out)
        print(f"[tbz] wrote {default_name}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

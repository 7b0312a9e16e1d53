"""Frontend dispatcher: bit stream -> token tape.

Mirrors the reference's monomorphized reader-context dispatch
(io.lisp:108-140) in spirit: several interchangeable frontends with one
contract, selected by availability/size:

  - 'native'  : C++ tokenizer (tbz/native), the fast host path
  - 'python'  : tbz.reference, the bit-exact oracle (always available)
  - 'device'  : all-device tokenizer (ops/tokenize_device), used by the
                fully-on-device pipeline

All produce identical tapes; tests cross-check them.
"""

from __future__ import annotations

from .tape import FrontendResult


def tokenize(data, bit_pos: int = 0, window_len: int = 0,
             frontend: str = "auto") -> FrontendResult:
    if frontend == "device":
        if bit_pos:
            raise ValueError("device frontend decodes whole streams "
                             "(bit_pos must be 0)")
        from .ops import tokenize_device as td
        return td.tokenize_auto(bytes(data), window_len)
    if frontend in ("auto", "native"):
        try:
            from .native import loader
            if loader.available():
                return loader.tokenize(data, bit_pos, window_len)
        except ImportError:
            pass
        if frontend == "native":
            raise RuntimeError("native frontend not available")
    elif frontend != "python":
        raise ValueError(f"unknown frontend {frontend!r}")
    from . import reference
    return reference.tokenize_host(data, bit_pos, window_len)

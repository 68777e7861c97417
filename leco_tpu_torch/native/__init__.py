"""The native BPE merge engine (`bpe.cpp`), built with g++ at first use and
bound with ctypes.

Counterpart of `leco_tpu/native/`. `load_bpe_library()` compiles `bpe.cpp`
into `native/_build/<hash of the source and flags>/libbpe.so` the first
time a process needs it and loads it; a later process over the same source
reuses the file. The port's tokenizer (`models/tokenizer.py`) takes the
engine unless `LECO_TPU_NATIVE=0`, and its ids are the pure-Python merge
loop's. A failed build prints the compiler's error and leaves the tokenizer
on the Python loop.

The port's copy of `bpe.cpp` takes each vocabulary string's id explicitly
(`bpe_create(tokens, ids, ...)`), so a vocabulary need not be dense.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "bpe.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
MAX_PIECES = 1024  # per word


def enabled() -> bool:
    """`LECO_TPU_NATIVE` (read when a tokenizer is made; default on)."""
    return os.environ.get("LECO_TPU_NATIVE", "1") != "0"


def build() -> Path:
    """Compile `bpe.cpp` unless a library for this source exists; -> its path.
    Raises with the compiler's output when the compile fails."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_ROOT / digest / "libbpe.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libbpe.so.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def load_bpe_library() -> Optional[ctypes.CDLL]:
    """The engine, built if needed, with its argtypes set; None (the
    compiler's or the loader's error printed) when it cannot be had."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        print(f"native BPE engine unavailable, using the Python merge loop: {err}",
              file=sys.stderr)
        return None
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
    ]
    lib.bpe_encode_word.restype = ctypes.c_int32
    lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBPE:
    """One vocabulary and merge list in the engine: byte-encoded words in,
    BPE ids out."""

    def __init__(self, lib: ctypes.CDLL, vocab: dict[str, int],
                 merges: list[tuple[str, str]]):
        self._lib = lib
        tokens = (ctypes.c_char_p * len(vocab))(*[t.encode() for t in vocab])
        ids = (ctypes.c_int32 * len(vocab))(*vocab.values())
        left = (ctypes.c_char_p * len(merges))(*[a.encode() for a, _ in merges])
        right = (ctypes.c_char_p * len(merges))(*[b.encode() for _, b in merges])
        self._handle = lib.bpe_create(tokens, ids, len(vocab), left, right, len(merges))
        self._buf = (ctypes.c_int32 * MAX_PIECES)()

    def encode_word(self, word: str) -> list[int]:
        """The ids of one byte-encoded word; KeyError when a merged piece is
        not in the vocabulary (the Python loop then takes the word)."""
        n = self._lib.bpe_encode_word(self._handle, word.encode(), self._buf, MAX_PIECES)
        ids = list(self._buf[:n])
        if any(i < 0 for i in ids):
            raise KeyError(f"native BPE produced a piece outside the vocabulary for {word!r}")
        return ids

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.bpe_destroy(handle)

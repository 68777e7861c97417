"""Build the repo's CUDA kernels with nvcc and bind them with ctypes.

`library()` compiles every `csrc/*.cu` into one shared library with a plain C
interface, at first use, into `kernels/_build/<hash of the sources>/`, and
loads it: one nvcc process per source, all started together, then one link.
A later call in the same process, or a later process over the same sources,
reuses the built file. Nothing here is imported or run on the CPU path: the
kernel wrappers in `leco_tpu_torch/ops/` call `library()` only for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libleco_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes; each returns its cudaGetLastError() as an int
SIGNATURES = {
    # q, k, v, o, lse, bh, nq, nk, d, scale, stream
    "leco_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, o, b, heads, nq, nk, c, scale, stream
    "leco_flash_fwd_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dO, lse, delta, dq, bh, nq, nk, d, scale, stream
    "leco_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, dO, lse, delta, dk, dv, bh, nq, nk, d, scale, stream
    "leco_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, w (packed: (9, cout, cin8)), bias, out, batch, cin, h, w, cout, stream
    "leco_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # w (OIHW), out (9, rows, cols8), cout, cin, flip, stream
    "leco_conv3x3_pack": [_P, _P, _I, _I, _I, _P],
    # x, a, s, w (packed), bias, out, batch, cin, h, w, cout, silu, stream
    "leco_gnconv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, y, batch, c, h*w, groups, eps, silu, stream
    "leco_group_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, w, bias, xd, up, out, m, k, n, r, stream
    "leco_geglu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def build() -> Path:
    """Compile the sources if no library for this source hash exists yet.
    Returns its path; the compiler's output (with ptxas' register and
    shared-memory report) is kept beside it in build.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = {src: out_dir / f"{src.stem}.{tag}.o" for src in sorted(CSRC.glob("*.cu"))}
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in objects.items()]
    # every source compiles at once; then one link
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    results = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in zip(cmds, procs)]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if all(rc == 0 for _, _, rc in results):
        cmd = [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objects.values())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        results.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
    (out_dir / "build.log").write_text(log)
    for obj in objects.values():
        obj.unlink(missing_ok=True)
    failed = [rc for _, _, rc in results if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    return (BUILD_ROOT / source_hash() / "build.log").read_text()

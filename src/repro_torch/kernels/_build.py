"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object of its
own, all sources at once, and the objects are linked into one shared library
with a plain C interface under ``build/repro_torch/`` in the checkout. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``-Xptxas -v`` output is
kept beside the library; :func:`ptxas_report` reads registers, static shared
memory and spills per kernel from it.

Each C entry point returns the ``cudaGetLastError()`` of its launch;
:func:`check` raises when that is not 0. Pointers and the stream go to C as
``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, kind, causal, window, logit_cap, ws, ws_floats, stream
    "repro_flash_attention_fwd": [_P, _P, _P, _P, *[_I] * 10, _F, _P, _LL, _P],
    # kind, d, dv, out (7 ints)
    "repro_flash_attention_config": [*[_I] * 3, _P],
    # x, w, y, rows, D, is_bf16, eps, stream
    "repro_rmsnorm_fwd": [_P, _P, _P, _LL, _I, _I, _F, _P],
    # a, b, h0, y, h_out, B, T, W, is_bf16, stream
    "repro_lru_scan_fwd": [_P, _P, _P, _P, _P, *[_I] * 4, _P],
    # B, T, W, is_bf16, misalign, out (9 ints)
    "repro_lru_scan_config": [*[_I] * 5, _P],
    # r, k, v, w, u, s0, y, s_out, B, H, T, d, is_bf16, stream
    "repro_wkv6_fwd": [*[_P] * 8, *[_I] * 5, _P],
    # d, is_bf16, out (5 ints)
    "repro_wkv6_config": [_I, _I, _P],
    # logits, idx, gate, pos, hist, G, N, E, k, capacity, renormalise, stream
    "repro_moe_gating_fwd": [*[_P] * 5, *[_I] * 6, _P],
    # N, E, k, out (9 ints)
    "repro_moe_gating_config": [*[_I] * 3, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's kernels are built from csrc/ at first use "
        "and need the CUDA toolkit"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library_path() -> Path:
    """Path of the built library; compiles it first if it is not there."""
    digest = _digest()
    lib = BUILD_DIR / f"librepro_torch_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{digest}.{os.getpid()}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}_{digest}.ptxas.txt").write_text(out)
        if proc.returncode:
            failed.append(f"nvcc failed on {src.name}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *[str(obj) for _, obj, _ in jobs], "-o", str(tmp)],
        capture_output=True, text=True,
    )
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic, so a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    if err:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?")


def ptxas_report() -> list[dict]:
    """Per kernel: registers, static shared memory and spill bytes, as ptxas
    printed them for the current library (the dynamic shared memory of the
    attention kernel is set at launch and not shown here)."""
    library_path()
    digest = _digest()
    rows: list[dict] = []
    for src in sources():
        log = BUILD_DIR / f"{src.stem}_{digest}.ptxas.txt"
        if not log.exists():  # library built by another process: logs are its
            continue
        current = None
        for line in log.read_text().splitlines():
            if m := _ENTRY.search(line):
                current = {"source": src.name, "kernel": _demangle(m.group(1)),
                           "registers": None, "smem_bytes": 0,
                           "spill_store_bytes": 0, "spill_load_bytes": 0}
                rows.append(current)
            elif current and (m := _SPILL.search(line)):
                current["spill_store_bytes"] = int(m.group(1))
                current["spill_load_bytes"] = int(m.group(2))
            elif current and (m := _USED.search(line)):
                current["registers"] = int(m.group(1))
                current["smem_bytes"] = int(m.group(2) or 0)
    return rows


def ptxas_warnings() -> list[str]:
    """The compiler's warnings for the current library, one line each, with
    the source's name (among them ptxas's notes that it serialised a
    kernel's ``wgmma`` instructions)."""
    library_path()
    digest = _digest()
    found = []
    for src in sources():
        log = BUILD_DIR / f"{src.stem}_{digest}.ptxas.txt"
        if log.exists():
            found += [f"{src.name}: {line.strip()}" for line in log.read_text().splitlines()
                      if "warning" in line.lower() or "performance" in line.lower()]
    return found


def _demangle(name: str) -> str:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True)
    return out.stdout.strip() or name

"""Build the port's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` under this package is compiled by ``nvcc`` for Hopper
(``sm_90a``) with a plain C interface — no PyTorch headers, so a full build
takes seconds — and linked into one ``.so`` loaded with :mod:`ctypes`.
Objects compile in parallel (one ``nvcc`` per source, all started
together). The library lands in ``build/repro_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an unchanged tree
builds once. A failed build raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

__all__ = ["load_library", "smem_optin", "check", "BUILD_ROOT"]

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parents[2] / "build" / "repro_torch"

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
]
# Per-source extras. The sweep must not contract adds into FMAs (it has no
# products, but the flag pins that for any later edit); the CNN wants FMAs.
_EXTRA = {"partition_sweep.cu": ["-fmad=false"]}


def _sources() -> List[Path]:
    return sorted(_PKG.glob("**/csrc/*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sources:
        h.update(str(p.relative_to(_PKG)).encode())
        h.update(" ".join(_EXTRA.get(p.name, [])).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


_P = ctypes.c_void_p
_I = ctypes.c_int
# The C entry points: name -> (argtypes, restype). Declared once, at load.
_SIGNATURES = {
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    "repro_smem_optin": ([_I, _P], _I),
    "repro_empty_launch": ([_I, _P], _I),
    "partition_sweep_smem_bytes": ([_I] * 4, ctypes.c_longlong),
    "partition_sweep_launch": ([_P, _P, _P, ctypes.c_double] + [_P] * 11 + [_I] * 7 + [_P],
                               _I),
    "conv_window_launch": ([_P] * 8 + [_I, _P], _I),
    "conv_window_frame_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "rmsnorm_launch": ([_P] * 3 + [_I, _I, ctypes.c_float, _I, _P], _I),
    "flash_attention_launch": ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _I, _I, _P], _I),
    "mlstm_chunk_scratch_floats": ([_I] * 3, ctypes.c_longlong),
    "mlstm_chunk_launch": ([_P] * 10 + [_I] * 5 + [_P], _I),
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernels' library, with
    every entry point's argument and result types declared."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib_path = out_dir / "librepro_torch_kernels.so"
    if not lib_path.exists():
        _compile(sources, out_dir, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on this card."""
    lib = load_library()
    limit = ctypes.c_int(0)
    check(lib, lib.repro_smem_optin(device_index, ctypes.addressof(limit)),
          "query shared memory")
    return limit.value


def _compile(sources: List[Path], out_dir: Path, lib_path: Path) -> None:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    procs = []
    objs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *_FLAGS, *_EXTRA.get(src.name, []), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    errors = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out_dir / f"lib.{tag}.so"
    link = subprocess.run(
        [nvcc, *_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n{link.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or nothing
    for obj in objs:
        obj.unlink()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise with CUDA's error text if a C entry point returned nonzero."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")

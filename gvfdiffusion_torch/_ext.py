"""Build and load the port's CUDA kernels.

The sources in `csrc/` have a plain C interface (no PyTorch headers): one
`nvcc -c` per source, all run at once, then one `nvcc -shared` link build
them in seconds. The library lands in
`.torch_ext_build/` at the repository root, named by a hash of the sources:
the first call after a change builds, later calls load. Tensors go in as
`data_ptr()`s and the stream as `torch.cuda.current_stream().cuda_stream`.

Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / ".torch_ext_build"
# wgmma/setmaxnreg exist only for the "a" target; name it explicitly
_ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argument types of each C entry point (pointers and the stream as c_void_p,
# element strides as c_longlong)
_SIGNATURES = {
    "gvf_self_sublayer": [_P] * 14 + [_I] * 5 + [_P],
    "gvf_temporal_sublayer": [_P] * 14 + [_I] * 5 + [_P],
    "gvf_cross_sublayer": [_P] + ([_P] * 9 + [_I]) * 2 + [_P] * 5
    + [_I] * 4 + [_P],
    "gvf_mlp_sublayer": [_P] * 11 + [_I] * 5 + [_P],
    "gvf_cross_sublayer1": [_P] * 10 + [_I] + [_L] * 2 + [_P] * 4 + [_I] * 5
    + [_P],
    "gvf_cross_sublayer1_q8": [_P] * 12 + [_I] + [_P] * 6 + [_I] * 6 + [_P],
    "gvf_attention": [_P] * 5 + [_I] * 5 + [_L] * 4
    + [_F, _F, _I, _I, _I, _P],
    "gvf_attention_q8": [_P] * 10 + [_I] * 5 + [_L] * 4 + [_I] * 3
    + [_F, _P],
    "gvf_temporal_attention": [_P] * 4 + [_I] * 5 + [_L] * 3 + [_F, _I, _P],
    "gvf_cross_sublayer_q8": [_P] + ([_P] * 11 + [_I]) * 2 + [_P] * 7
    + [_I] * 5 + [_P],
    "gvf_flash_attention": [_P] * 7 + [_I] * 5 + [_L] * 6 + [_F, _I, _I, _P],
    "gvf_flash_attention_bwd_dkv": [_P] * 10 + [_I] * 5 + [_L] * 6
    + [_F, _I, _P],
    "gvf_flash_attention_bwd_dq": [_P] * 9 + [_I] * 5 + [_L] * 6
    + [_F, _I, _P],
    "gvf_flash_attention_bwd_dkv_bf16": [_P] * 10 + [_I] * 5 + [_L] * 6
    + [_F, _I, _P],
    "gvf_flash_attention_bwd_dq_bf16": [_P] * 9 + [_I] * 5 + [_L] * 6
    + [_F, _I, _P],
    "gvf_flash_attention_wide": [_P] * 7 + [_I] * 5 + [_L] * 6
    + [_F] + [_I] * 4 + [_P],
    "gvf_flash_attention_wide_bwd_dkv": [_P] * 10 + [_I] * 5 + [_L] * 6
    + [_F] + [_I] * 3 + [_P],
    "gvf_flash_attention_wide_bwd_dq": [_P] * 9 + [_I] * 5 + [_L] * 6
    + [_F] + [_I] * 3 + [_P],
    "gvf_flash_attention_wide_bwd_dkv_bf16": [_P] * 10 + [_I] * 5 + [_L] * 6
    + [_F] + [_I] * 3 + [_P],
    "gvf_flash_attention_wide_bwd_dq_bf16": [_P] * 9 + [_I] * 5 + [_L] * 6
    + [_F] + [_I] * 3 + [_P],
    "gvf_cross_sublayer1_f32": [_P] * 10 + [_I] + [_L] * 2 + [_P] * 5
    + [_I] * 4 + [_P],
    "gvf_self_sublayer_q8": [_P] * 18 + [_I] * 5 + [_P],
    "gvf_temporal_sublayer_q8": [_P] * 18 + [_I] * 6 + [_P],
    "gvf_temporal_attention_sm90": [_P] * 6 + [_I] * 6 + [_P],
}

_lib = None
_lock = threading.Lock()


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_ARCH_FLAGS).encode())
    return _BUILD_DIR / f"libgvf_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands at once; raise with the output of any that fails
    (every one is waited for)."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    failed = []
    for c, p in procs:
        output = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{' '.join(c)} ({p.returncode}):\n{output}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _build(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in srcs]
    nvcc = [_nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3"]
    try:
        _run([[*nvcc, "-c", "-Xcompiler", "-fPIC", "-o", str(o), str(p)]
              for p, o in zip(srcs, objs)])
        _run([[*nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing


def ptxas_report(source: str) -> str:
    """What ptxas reports for one source of `csrc/` (registers, shared
    memory and spills of each kernel): one `nvcc -c -Xptxas=-v` to a
    scratch object, apart from the library's build."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _BUILD_DIR / f"ptxas.{os.getpid()}.o"
    cmd = [_nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-c",
           "-o", str(obj), str(_CSRC / source)]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    finally:
        obj.unlink(missing_ok=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed ({out.returncode}):\n{out.stdout}")
    return out.stdout


def load():
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gvf_error_string.argtypes = [ctypes.c_int]
            lib.gvf_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Run one C entry point on the current stream; raise on a CUDA error."""
    import torch

    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.gvf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")

"""Build the port's CUDA kernels and load them with ctypes.

The ``.cu`` sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface.  The library goes
into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one is reused.  The build runs on first use, never at import:
a machine without ``nvcc`` imports this module fine and fails only when a
kernel is asked for.

Usage on a machine with a card and the CUDA toolkit::

    python -m repro_torch.kernels.build     # builds, prints the .so path
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fed_reduce.cu", "fed_aggregate.cu", "rglru_scan.cu",
           "flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_bf16.cu", "flash_attention_bwd_bf16.cu")
HEADERS = ("common.cuh", "attn_bf16.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda): the CUDA kernels cannot be built")


def source_hash(csrc: Path = CSRC, sources=SOURCES) -> str:
    h = hashlib.sha256()
    # an older checkout may lack a header this one has
    for name in tuple(sources) + tuple(
            x for x in HEADERS if (Path(csrc) / x).exists()):
        h.update(name.encode())
        h.update((Path(csrc) / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
                 sources=SOURCES) -> Path:
    return Path(build_dir) / f"libfedkernels-{source_hash(csrc, sources)}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
          sources=SOURCES) -> Path:
    """Compile and link ``sources`` (of ``csrc``, the port's own by
    default) unless this source hash is built.  Returns the shared
    library's path; the compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it in a ``.log``
    file.  Raises on any compiler error."""
    csrc, build_dir = Path(csrc), Path(build_dir)
    out = library_path(csrc, build_dir, sources)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(csrc / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== nvcc {src} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                               + "\n".join(logs))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so, out)      # atomic: a reader never sees half a file
    return out


def _entry_points():
    """Each source's C entry points, their argument types (pointers and
    the stream as ``c_void_p``, sizes as ``c_int``, strides as
    ``c_longlong``, a host array of strides or a result array as a
    ``c_longlong`` pointer) and, where it is not ``c_int``, the result
    type."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    return {
        "fed_reduce.cu": [("fed_reduce_f32",
                           [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                            ptr]),
                          ("fed_reduce_quant_f32",
                           [ptr] * 8 + [i32, ptr] + [i32] * 5 + [ptr]),
                          ("fed_reduce_quant_absmax_f32",
                           [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr])],
        "fed_aggregate.cu": [("fed_aggregate_f32",
                              [ptr, ptr, ptr, ptr, i32, i32, i32, ptr])],
        "rglru_scan.cu": [("rglru_scan_f32",
                           [ptr, ptr, ptr, i32, i32, i32, i32, ptr]),
                          ("rglru_scan_bwd_f32",
                           [ptr] * 5 + [i32] * 4 + [ptr]),
                          ("rglru_scan_bf16",
                           [ptr, ptr, ptr, i32, i32, i32, i32, ptr])],
        "flash_attention.cu": [("flash_attention_f32",
                                [ptr] * 6 + [i64] * 12 + [i32] * 8
                                + [f32] * 2 + [i32, ptr])],
        "flash_attention_bwd.cu": [("flash_attention_bwd_f32",
                                    [ptr] * 10 + [ctypes.POINTER(i64)]
                                    + [i32] * 8 + [f32] * 2 + [i32, ptr]),
                                   ("flash_attention_bwd_plan_f32",
                                    [i32] * 7 + [ctypes.POINTER(i64)], i64)],
        "flash_attention_bf16.cu": [("flash_attention_bf16",
                                     [ptr] * 5 + [i64] * 12 + [i32] * 8
                                     + [f32] * 2 + [i32, ptr])],
        "flash_attention_bwd_bf16.cu": [("flash_attention_bwd_bf16",
                                         [ptr] * 10 + [ctypes.POINTER(i64)]
                                         + [i32] * 8 + [f32] * 2
                                         + [i32, ptr]),
                                        ("flash_attention_bwd_plan_bf16",
                                         [i32] * 7 + [ctypes.POINTER(i64)],
                                         i64)],
    }


@functools.lru_cache(maxsize=None)
def library(csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
            sources=SOURCES) -> ctypes.CDLL:
    """The built kernels, loaded once per process, with every entry
    point's argument and result types declared.  The defaults are the
    port's own kernels; another ``csrc`` (an older checkout's, say)
    builds into its own library beside them, and an entry point that an
    older checkout does not have yet is left out of its library."""
    lib = ctypes.CDLL(str(build(csrc, build_dir, sources)))
    own = Path(csrc).resolve() == CSRC
    for src, entries in _entry_points().items():
        if src in sources:
            for name, argtypes, *restype in entries:
                if not own and not hasattr(lib, name):
                    continue
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype[0] if restype else ctypes.c_int
    return lib


if __name__ == "__main__":
    print(build())

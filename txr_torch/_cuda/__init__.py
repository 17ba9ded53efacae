"""Build and load the package's hand-written CUDA kernels.

The sources in ``txr_torch/csrc/*.cu`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
``ctypes``. Nothing is built when a module is imported: the first wrapper
that is handed a CUDA tensor calls :func:`lib`, which builds (once per
content hash of the sources) into ``build/txr_torch_kernels/`` under the
repository root and loads the result. Each source is compiled by its own
``nvcc`` process, all started together, and the objects are linked last.

Kernels launch on PyTorch's current stream and do not synchronise; the C
functions return ``cudaGetLastError()`` and :func:`check` raises on a
non-zero code. :data:`launches` counts, per kernel, how often its wrapper
launched it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "txr_torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

# kernel name -> launches made by its wrapper (see each ops module)
launches: Dict[str, int] = {"attention": 0, "attention_boundmax": 0,
                            "attention_key_norm": 0, "attention_bhsd": 0,
                            "attention_cached": 0,
                            "dpt_tail": 0, "segscan": 0, "offset_reduce": 0,
                            "int8_linear": 0, "conv3x3": 0, "qk_prep": 0,
                            "merge_sorted": 0, "residual_norm": 0,
                            "upsample": 0}

build_log: str = ""                     # nvcc's output (ptxas -v when asked)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Multiprocessors of a CUDA device: the most blocks a persistent grid
    is given."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "txr_torch needs nvcc to build its CUDA kernels and found none "
        "(looked at CUDA_HOME, PATH and /usr/local/cuda)")


def _content_hash(files: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernel sources into one shared library; return its path.

    A library whose name carries the hash of the current sources is reused.
    ``verbose`` adds ``-Xptxas -v`` so :data:`build_log` holds each kernel's
    registers, shared memory and spills. Raises ``RuntimeError`` with nvcc's
    output when a compile or the link fails.
    """
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    tag = _content_hash(srcs + _headers())
    out = BUILD_DIR / f"libtxr_torch_kernels_{tag}.so"
    if out.exists() and not verbose:
        return out
    nvcc = _find_nvcc()
    work = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    include = ["-I", str(CSRC_DIR)]
    procs = []
    for src in srcs:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, *include, "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name} ==\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs], "-ldl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log += f"\n== link ==\n{link.stdout}"
    if link.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed to link the kernels:\n{build_log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            _declare(handle)
            _lib = handle
    return _lib


def _declare(h: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    h.txr_cuda_error_string.argtypes = [i]
    h.txr_cuda_error_string.restype = ctypes.c_char_p
    # (qkv, out, B, S, H, kv_len, scale, key_norm or None, stream)
    h.txr_attention_fwd.argtypes = [p, p, i, i, i, i, f, p, p]
    h.txr_attention_fwd.restype = i
    # (qkv, kn, B, S, H, stream)
    h.txr_attention_key_norm.argtypes = [p, p, i, i, i, p]
    h.txr_attention_key_norm.restype = i
    # (qkv, kv, out, S, H, kv_len, cached, frame_tokens, scale, stream)
    h.txr_attention_cached_fwd.argtypes = [p, p, p, i, i, i, i, i, f, p]
    h.txr_attention_cached_fwd.restype = i
    # (out[4]: query rows per block, keys per tile, smem bytes, threads)
    h.txr_attention_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_attention_geometry.restype = None
    # (q, k, v, out, B, H, S, kv_len, scale, strides[12], stream)
    h.txr_attention_bhsd_fwd.argtypes = [p, p, p, p, i, i, i, i, f,
                                         ctypes.POINTER(ll), p]
    h.txr_attention_bhsd_fwd.restype = i
    # (x, wq, sw, bias, xq, sx, out, M, K, N, sms, stream)
    h.txr_int8_linear_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    h.txr_int8_linear_fwd.restype = i
    # its two halves on their own: (x, xq, sx, M, K, stream) and
    # (xq, wq, sx, sw, bias, out, M, K, N, sms, stream)
    h.txr_int8_quantize_rows.argtypes = [p, p, p, i, i, p]
    h.txr_int8_quantize_rows.restype = i
    h.txr_int8_gemm.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    h.txr_int8_gemm.restype = i
    # (out[4]: tile rows, tile columns, stages, smem bytes)
    h.txr_int8_linear_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_int8_linear_geometry.restype = None
    # (out[4]: tile height, tile width, features per block, smem bytes)
    h.txr_conv3x3_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_conv3x3_geometry.restype = None
    # (x, wp, bias, out, B, H, W, C, F, relu_in, stream)
    h.txr_conv3x3_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    h.txr_conv3x3_fwd.restype = i
    # (x, w2p, b2, w3, b3, pos or null, out, B, Hin, Win, C, out_h, out_w,
    # nout, sms, stream)
    h.txr_dpt_tail_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   i, p]
    h.txr_dpt_tail_fwd.restype = i
    # (B, Hin, Win, C, out_h, out_w, sms, out[8]: tile height, tile width,
    # window rows, window columns, window buffers, smem bytes, grid, threads)
    h.txr_dpt_tail_geometry.argtypes = [i, i, i, i, i, i, i,
                                        ctypes.POINTER(i)]
    h.txr_dpt_tail_geometry.restype = i
    # (out[4]: rows per tile, threads, rows per thread, most columns)
    h.txr_segscan_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_segscan_geometry.restype = None
    # (cols[], starts, out, n, ncols, fscratch, iscratch, stream)
    h.txr_segscan_fwd.argtypes = [ctypes.POINTER(p), p, p, ll, i, p, p, p]
    h.txr_segscan_fwd.restype = i
    # (skey, perm, yzw, rgb, n, cap, khi, klo_x, yzw, rgb out, fscratch,
    # iscratch, stream)
    h.txr_offset_reduce_fwd.argtypes = [p, p, p, p, ll, i, p, p, p, p, p, p,
                                        p]
    h.txr_offset_reduce_fwd.restype = i
    # (out[4]: head width, threads a block, rows a block, threads a row)
    h.txr_qk_prep_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_qk_prep_geometry.restype = None
    # (qkv, cos, sin, q weight, q bias, k weight, k bias, B, S, H, eps,
    # stream)
    h.txr_qk_prep_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f, p]
    h.txr_qk_prep_fwd.restype = i
    # (out[4]: rows a tile, threads a merge block, rows a thread, threads a
    # partition block)
    h.txr_merge_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_merge_geometry.restype = None
    # (khi, klo_x, tail key, tail perm, n_head, n_tail, key out, perm out,
    # splits, stream)
    h.txr_merge_sorted_fwd.argtypes = [p, p, p, p, ll, ll, p, p, p, p]
    h.txr_merge_sorted_fwd.restype = i
    # (out[4]: threads a block, rows a block, values a chunk, widest row)
    h.txr_residual_norm_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_residual_norm_geometry.restype = None
    # (x, branch, gamma, norm weight or null, norm bias or null, x' out,
    # h out or null, rows, width, dtypes bits, eps, stream)
    h.txr_residual_norm_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f, p]
    h.txr_residual_norm_fwd.restype = i
    # (out[4]: threads a block, chunks a segment, widest chunk in bytes,
    # most channels a chunk)
    h.txr_upsample_geometry.argtypes = [ctypes.POINTER(i)]
    h.txr_upsample_geometry.restype = None
    # (x, y, n, h, w, c, out h, out w, align_corners, channels a chunk,
    # dtypes bits, stream)
    h.txr_upsample_bilinear_fwd.argtypes = [p, p, i, i, i, i, i, i, i, i, i,
                                            p]
    h.txr_upsample_bilinear_fwd.restype = i


def check(err: int, kernel: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        text = lib().txr_cuda_error_string(err)
        raise RuntimeError(
            f"txr_torch kernel '{kernel}' failed to launch: CUDA error "
            f"{err} ({text.decode() if text else 'unknown'})")

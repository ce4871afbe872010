"""Build and load the CUDA kernels in ``fitclip_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs on first use,
never at import, into ``build/fitclip_torch/<hash>/`` at the root of the
checkout; the hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the library already built. Only the
sources in this package are compiled. A missing ``nvcc`` or a failed build
raises with the compiler's output: nothing falls back to the plain versions.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
``call`` raises if that is not 0.

Every kernel entry on an inference path is also an operator of the
``fitclip`` namespace (``define_op``): its CUDA implementation launches the
kernel through ``call``, its CPU implementation is the kernel's plain PyTorch
version, and its fake implementation gives shapes and dtypes only, so that
``torch.export`` traces it without building or loading the library. The ops
are registered with ``torch.library.Library`` and ``impl``: at one dispatch
per launch, that costs the host less than ``torch.library.custom_op``'s
Python wrapper and autograd kernel.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from fitclip_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "fitclip_torch"
LIBRARY_NAME = "libfitclip_kernels.so"
# No --use_fast_math: the kernels' divides, exp2f and rounding must stay IEEE
# to agree with the plain PyTorch versions.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, x_dtype, gamma, beta, out, rows, width, inv, eps, mode, stream
    "fitclip_ln_quant": (_P, _I, _P, _P, _P, _I, _I, _F, _F, _I, _P),
    # x, x_dtype, gamma, beta, out (bf16), rows, width, eps, stream
    "fitclip_ln_cast": (_P, _I, _P, _P, _P, _I, _I, _F, _P),
    # a, w, m, n, k, epilogue, scale, bias, residual, res_dtype, out, out_dtype, kv, act, stream
    "fitclip_int8_gemm": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I, _F, _I, _P),
    # a, w, m, n, k, epilogue, bias, residual, res_dtype, out, out_dtype, quick, stream
    "fitclip_bf16_gemm": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P),
    # qkv, dtype, out, mode, batch, seq, heads, head_dim, scale, causal,
    # seq_valid, out_mul, body, stream
    "fitclip_attention": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I, _P),
    # qkv, grad, dtype, dqkv, stats, batch, seq, heads, head_dim, scale, causal, body,
    # stream
    "fitclip_attention_bwd": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # qkv, qkv_clip_stride, gkv, gkv_stride, dtype, out, out_clip_stride, int8_out,
    # groups (space) or clips (time), frames, patches, heads, head_dim, scale, out_mul, stream
    "fitclip_fit_space_attention": (_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                    _P),
    "fitclip_fit_time_attention": (_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                   _P),
    # qkv, dtype, out, out_clip_stride, clips, seq, heads, head_dim, scale, out_mul, stream
    "fitclip_fit_cls_attention": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    # x, packed weights, bias, out, batch, frames, height, width, stream
    "fitclip_s3dg_stem": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # qkv, dtype, out, clips, n, row0, rows, width, inv, stream
    "fitclip_slice_requant": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _P),
    # qkv, scales, frames, seq, width, block, stream
    "fitclip_attn_amax": (_P, _P, _I, _I, _I, _I, _P),
    # qkv, scales, out, frames, seq, heads, block, scale, av8, stream
    "fitclip_attention_s8": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
}
# The size_t shared-memory queries: name -> their int arguments.
_SMEM_QUERIES = {
    "fitclip_attention_bwd_smem_bytes": 3,  # seq, head_dim, body
    "fitclip_fit_space_smem_bytes": 2,      # dtype, patches
    "fitclip_fit_cls_smem_bytes": 1,        # seq
    "fitclip_s3dg_stem_smem_bytes": 1,      # frame width
    "fitclip_attention_s8_smem_bytes": 2,   # seq, av8
}
# The int queries: name -> their int arguments.
_INT_QUERIES = {
    "fitclip_attention_body": 3,  # dtype, seq, head_dim -> attention.cu's body, or -1
    "fitclip_attention_bwd_body": 3,  # dtype, seq, head_dim -> attention_bwd.cu's body, or -1
}


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).is_file():
        raise RuntimeError("nvcc not found: building the fitclip_torch CUDA kernels "
                           "needs the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc


def build() -> Path:
    """Compile csrc/*.cu into one .so (if not built already); return its path.
    Each source compiles in its own nvcc process, all started together, then
    one link."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    library = out_dir / LIBRARY_NAME
    if library.is_file():
        return library
    out_dir.mkdir(parents=True, exist_ok=True)
    count("kernel_builds")
    nvcc = _nvcc()
    tag = os.getpid()
    units = [(src, out_dir / f"{src.stem}.{tag}.o") for src in sources() if src.suffix == ".cu"]
    objects = [obj for _, obj in units]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in units]
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(compiles)) as pool:
        procs = list(pool.map(_run, compiles))
    partial = out_dir / f"{LIBRARY_NAME}.{tag}.partial"
    _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(partial), *(str(o) for o in objects)])
    # ptxas -v: registers, shared memory and spills of each kernel.
    (out_dir / "ptxas.txt").write_text("".join(p.stdout + p.stderr for p in procs))
    os.replace(partial, library)  # atomic: a concurrent build never loads a partial file
    for obj in objects:
        obj.unlink()
    return library


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    with span("kernel_library"):
        return _load()


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fitclip_error_string.argtypes = (ctypes.c_int,)
    lib.fitclip_error_string.restype = ctypes.c_char_p
    for queries, restype in ((_SMEM_QUERIES, ctypes.c_size_t), (_INT_QUERIES, ctypes.c_int)):
        for name, count in queries.items():
            getattr(lib, name).argtypes = (ctypes.c_int,) * count
            getattr(lib, name).restype = restype
    return lib


def call(name: str, *args) -> None:
    """Launch the C entry point `name` on the current stream; raise on a CUDA error."""
    lib = library()
    code = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({lib.fitclip_error_string(code).decode()})")


# The fitclip operator namespace; custom_op's own fragment (fused_attention_qkv)
# lives beside it.
LIBRARY = torch.library.Library("fitclip", "FRAGMENT")


def define_op(schema: str, cuda, cpu, fake):
    """Register ``fitclip::<schema>`` with a CUDA implementation (the kernel's
    launch), a CPU one (its plain version, made contiguous as the kernels'
    outputs and the fake ones are) and a fake one (shapes and dtypes only);
    return its overload. No implementation may return a view of an input: the
    schema declares no alias."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, lambda *args: cpu(*args).contiguous(), "CPU")
    torch.library.register_fake(f"fitclip::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.fitclip, name).default


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
    return DTYPE_CODES[dtype]


def check_cuda_operand(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    """Raise on what the kernels do not take: wrong device, dtype, rank,
    non-contiguous data or a pointer not aligned to 16 bytes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")

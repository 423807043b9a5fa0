"""CUDA kernels of flash attention (forward and recompute backward), bound
with ctypes.

``csrc/flash_attention.cu`` holds the three kernels, each in two designs
(bf16 inputs on the tensor cores with ``wgmma``, fp32 inputs on the CUDA
cores), and a note on them; together they replace
``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py`` (a forward only) and the
differentiated chunked path of its ``models/attention.py``: the forward
(output and log-sum-exp), then for the backward the dQ kernel (which also
writes ``D = rowsum(dO * O)``) and the dK / dV kernel, two launches on the
current stream.  The library is built by ``nvcc`` at first use
(``kernels/cuda.py``); nothing is compiled or imported from CUDA when this
module is imported.

The wrappers take contiguous CUDA tensors in the model's layout (q (B, Sq,
H, dh), k / v (B, Sk, KV, dh), fp32 or bf16 alike, dh <= 128), check
them, allocate the outputs, raise if a launch reports an error, and add
one to ``LAUNCHES["flash_fwd"]``, ``["flash_bwd_dq"]`` or
``["flash_bwd_dkdv"]`` as they launch each.  The plain versions are
``kernels/ref.py::flash_attention`` and ``flash_attention_bwd``;
``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import attn_scale

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# Launch counts per kernel, for showing that a run went through them.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0}

MAX_DH = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda.build(SOURCE)[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i, i, i, i, i, i, f, i, p]
        lib.flash_fwd.argtypes = [i, p, p, p, p, p] + dims
        lib.flash_bwd_dq.argtypes = [i, p, p, p, p, p, p, p, p] + dims
        lib.flash_bwd_dkdv.argtypes = [i, p, p, p, p, p, p, p, p] + dims
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkdv):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Check q / k / v and return (dtype code, B, H, KV, Sq, Sk, dh)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, Sq, H, dh) and k / v (B, Sk, KV, "
                         f"dh), got {tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes fp32 or bf16, got "
                         f"{q.dtype}")
    if min(b, sq, sk, h, kv, dh) < 1 or h % kv or dh > MAX_DH:
        raise ValueError(f"flash attention: B {b}, Sq {sq}, Sk {sk}, H {h}, "
                         f"KV {kv}, dh {dh}: needs H % KV == 0 and 1 <= dh "
                         f"<= {MAX_DH}")
    cuda.check("q", q, (b, sq, h, dh), q.dtype)
    cuda.check("k", k, (b, sk, kv, dh), q.dtype)
    cuda.check("v", v, (b, sk, kv, dh), q.dtype)
    return DTYPES[q.dtype], b, h, kv, sq, sk, dh


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True):
    """Returns ``(out (B, Sq, H, dh) in q's dtype, lse (B, H, Sq) fp32)``."""
    code, b, h, kv, sq, sk, dh = _dims(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _lib().flash_fwd(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), b, h, kv, sq, sk,
                           dh, attn_scale(dh), int(causal), cuda.stream(q))
    cuda.raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def backward(q, k, v, o, lse, do, causal: bool = True):
    """dQ, then dK and dV, from the forward's output and log-sum-exp and
    the output's gradient ``do`` (like q).  Returns ``(dq, dk, dv)`` in
    q's dtype."""
    code, b, h, kv, sq, sk, dh = _dims(q, k, v)
    cuda.check("o", o, tuple(q.shape), q.dtype)
    cuda.check("do", do, tuple(q.shape), q.dtype)
    cuda.check("lse", lse, (b, h, sq))
    dsum = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (b, h, kv, sq, sk, dh, attn_scale(dh), int(causal),
            cuda.stream(q))
    lib = _lib()
    err = lib.flash_bwd_dq(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           dsum.data_ptr(), dq.data_ptr(), *dims)
    cuda.raise_on(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    err = lib.flash_bwd_dkdv(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), *dims)
    cuda.raise_on(err, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dq, dk, dv

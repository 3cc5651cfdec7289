"""Scaled dot-product attention in the JAX package's (B, N, H, D) layout.

Counterpart of ``sculptmate_tpu/ops/attention.py:dot_product_attention``.
On a CUDA tensor every call launches kernel K1 (``csrc/flash_attn.cu``), a
flash-attention forward that masks ragged sequence tails itself, so the port
has one attention path on the card whatever the sequence lengths. On a CPU
tensor it computes the same function with the query-chunked softmax of the
JAX package's fallback path, which bounds the score tensor's memory.
"""

from __future__ import annotations

import ctypes

import torch

from sculptmate_tpu_torch.runtime import kernels

# chunk queries so heads * q_chunk * Nk * 4B stays near this budget
_SCORE_BYTES_BUDGET = 128 * 1024 * 1024
_HEAD_DIMS = (64, 88)  # the head widths kernel K1 is built for


def dot_product_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Query-chunked softmax(q k^T / sqrt(D)) v; scores in f32, the
    probabilities cast back to the input dtype before the value product."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    q_chunk = min(max(128, _SCORE_BYTES_BUDGET // max(B * H * Nk * 4, 1)), Nq)
    scale = torch.tensor(1.0 / D**0.5, dtype=q.dtype, device=q.device)
    qt = q.transpose(1, 2)  # (B, H, Nq, D)
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    out = []
    with torch.autocast(q.device.type, enabled=False):  # the scores stay f32
        for s0 in range(0, Nq, q_chunk):
            qc = (qt[:, :, s0 : s0 + q_chunk] * scale).float()
            p = torch.softmax(qc @ kt.transpose(-1, -2), dim=-1).to(q.dtype)
            out.append(p @ vt)
    return torch.cat(out, dim=2).transpose(1, 2)


def _flash_lib():
    lib = kernels.load("flash_attn")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on CUDA tensors (bf16 or f32, D = 64 or 88)."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims {_HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention kernel takes bf16 or f32, got {q.dtype}")
    if k.shape != (B, Nk, H, D) or v.shape != k.shape or Nk == 0:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise TypeError("q, k and v must share dtype and device")
    # TMA reads the contiguous (B, N, H, D) layout from a 16-byte aligned base
    q, k, v = (kernels.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Nq, Nk, H, D, int(q.dtype == torch.bfloat16), stream,
    )
    kernels.check(err, "flash_attn_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, H, D), k/v (B, Nk, H, D) -> (B, Nq, H, D)."""
    if q.is_cuda:
        return flash_attention(q, k, v)
    return dot_product_attention_plain(q, k, v)

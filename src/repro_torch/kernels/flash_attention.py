"""Flash attention (forward and backward): the CUDA kernels' wrappers, their
``torch.autograd.Function`` and the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``; body ``_flash_kernel``), which has no backward.  The
kernels are ``csrc/flash_attention.cu``: the forward walks the KV tiles of
a q tile with the online softmax and also writes the row log-sum-exp; the
backward recomputes the probabilities from it (D = rowsum(dO * O), then
dK/dV per kv tile and dQ per q tile: no atomics, deterministic).  Layout
q/k/v [B, H, S, hd] with the heads already expanded for GQA; the causal
mask is top-left (``kpos <= qpos``), so ``causal=True`` needs Sq == Sk.

On the card, operations and bytes bound the work about equally at the
training shape (S = 1024, hd = 128), so the products belong on the tensor
cores with the loads overlapping them.  bfloat16 runs the tensor-core
kernels: warp-specialised CTAs in which one producer thread keeps TMA
loads in flight through mbarrier rings while two consumer warpgroups run
``wgmma`` (the forward persistent, its softmax in registers; the backward
recomputing P from the log-sum-exp); zamba2's hd 80 runs in the hd-128
tiles, the TMA zero-filling columns 80-127 (1.6x the products of a true
hd-80 tile).  float32 runs the first version's
FMA kernels on the CUDA cores, since the fp32 parity checks hold it to
1e-4, which TF32 products would not meet.  Either way a CUDA tensor
launches a kernel or raises; the plain version runs only for CPU
tensors.

``FWD_COUNTS`` / ``BWD_COUNTS``: ``"cuda"`` counts kernel launches,
``"torch"`` calls of the plain version's forward and of its backward (an
autograd hook); ``repro_torch.kernels.ops`` reads and resets them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

FWD_COUNTS = {"cuda": 0, "torch": 0}
BWD_COUNTS = {"cuda": 0, "torch": 0}
#: head dims the kernels take (qwen3 and olmo use 128, zamba2's shared
#: attention 80: in bf16 it runs in the hd-128 tensor-core tiles, the
#: columns past 80 zero-filled by the TMA)
HEAD_DIMS = (64, 80, 128)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Shape rules shared by the kernel and the plain version."""
    req = build.require
    req(q.ndim == 4 and k.ndim == 4 and v.ndim == 4, "q, k and v must be [B, H, S, hd]")
    req(k.shape == v.shape, f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    req(q.shape[:2] == k.shape[:2] and q.shape[3] == k.shape[3],
        f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or hd")
    req(not causal or q.shape[2] == k.shape[2],
        f"causal attention needs Sq == Sk (the mask is top-left aligned), "
        f"got Sq={q.shape[2]}, Sk={k.shape[2]}")


def flash_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Plain version: masked softmax attention in fp32, differentiable by
    autograd.  q: [B, H, Sq, hd]; k/v: [B, H, Sk, hd] -> [B, H, Sq, hd] in
    q's dtype."""
    check_shapes(q, k, v, causal)
    FWD_COUNTS["torch"] += 1
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    out = out.to(q.dtype)
    if out.requires_grad:
        out.register_hook(_count_plain_backward)
    return out


def _count_plain_backward(grad: torch.Tensor) -> None:
    BWD_COUNTS["torch"] += 1


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream.  q: [B, H, Sq, hd];
    k/v: [B, H, Sk, hd]; one dtype (float32 or bfloat16), contiguous, on one
    CUDA device.  Returns ``(out [B, H, Sq, hd], lse [B, H, Sq] fp32)``."""
    _check(q, k, v, causal=causal)
    b, h, sq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, sq, k.shape[2], hd, int(causal), build.DTYPE_CODES[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "flash_attention_fwd")
    FWD_COUNTS["cuda"] += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the current stream: ``(dq, dk, dv)``
    of the forward's inputs from ``dout``, recomputing the probabilities
    from ``lse``."""
    _check(q, k, v, out, dout, causal=causal)
    b, h, sq, hd = q.shape
    req = build.require
    req(out.shape == q.shape and dout.shape == q.shape, "out / dout must match q")
    req(lse.dtype == torch.float32 and lse.shape == (b, h, sq) and lse.is_contiguous(),
        "lse must be contiguous fp32 [B, H, Sq]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, sq, k.shape[2], hd, int(causal),
        build.DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(lib, err, "flash_attention_bwd")
    BWD_COUNTS["cuda"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward launches the
    forward kernel and saves (q, k, v, out, lse); the backward launches the
    backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal
        )
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """The kernel, differentiable.  q: [B, H, Sq, hd]; k/v: [B, H, Sk, hd]
    (CUDA, contiguous, one dtype).  Returns [B, H, Sq, hd]."""
    return FlashAttention.apply(q, k, v, causal)


def _check(*tensors, causal: bool) -> None:
    req = build.require
    q, k, v = tensors[:3]
    req(all(t.is_cuda for t in tensors), "flash_attention kernel needs CUDA tensors")
    req(all(t.device == q.device for t in tensors), "tensors on different devices")
    req(q.dtype in build.DTYPE_CODES, f"unsupported dtype {q.dtype}")
    req(all(t.dtype == q.dtype for t in tensors), "q, k, v (and out, dout) must share one dtype")
    check_shapes(q, k, v, causal)
    req(q.shape[3] in HEAD_DIMS, f"head_dim {q.shape[3]} not in {HEAD_DIMS}")
    req(q.shape[2] > 0 and k.shape[2] > 0, "empty sequence")
    req(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in tensors), "tensors must be 16-byte aligned")

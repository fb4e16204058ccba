"""The plain reference: a dense decoder-only transformer in plain PyTorch.

It covers both configurations' options: RMSNorm with a weight or a
LayerNorm without one, q/k RMSNorm before RoPE (Qwen3), grouped-query
attention, split-half RoPE, SwiGLU, a tied or untied head.  It reads the
benchmark's weight tree by path (``embed``, ``layers/attn/wq`` ...), made by
the benchmark and never by the program, and imports nothing of the program.

Precision: ``"fp32"`` computes every product in float32 (the caller turns
TF32 off); ``"fp8"`` is the control, each product's operands rounded to
float8 e4m3 with one scale a tensor (its largest magnitude to 448), in the
backward too, and summed in float32.  Causal attention is written out
(scores, mask, softmax, weighted sum), not a fused kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, in float32."""
    s = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Mm8(torch.autograd.Function):
    """``a @ b`` with both operands rounded to e4m3, and the gradient's
    products likewise (``b`` is 2-D, or has ``a``'s batch dims)."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = q8(a), q8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = q8(g)
        ga = g8 @ b8.transpose(-1, -2)
        if b8.dim() == 2:
            gb = a8.reshape(-1, a8.shape[-1]).T @ g8.reshape(-1, g8.shape[-1])
        else:
            gb = a8.transpose(-1, -2) @ g8
        return ga, gb


def matmul(mode: str):
    if mode == "fp32":
        return torch.matmul
    if mode == "fp8":
        return _Mm8.apply
    raise ValueError(f"unknown precision {mode!r}")


def _norm(m: dict, x: torch.Tensor, w) -> torch.Tensor:
    if m.get("norm_type", "rmsnorm") == "layernorm":
        y = F.layer_norm(x, x.shape[-1:], eps=m["norm_eps"])
    else:
        y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + m["norm_eps"])
    return y if w is None else y * w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of ``x`` [B, S, H, hd] at positions 0 .. S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _layer(m: dict, lp: dict, x: torch.Tensor, mm) -> torch.Tensor:
    bsz, s, d = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]

    def proj(t, w):
        return mm(t.reshape(-1, t.shape[-1]), w.reshape(t.shape[-1], -1))

    a = _norm(m, x, lp.get("ln1"))
    q = proj(a, lp["wq"]).view(bsz, s, h, hd)
    k = proj(a, lp["wk"]).view(bsz, s, kv, hd)
    v = proj(a, lp["wv"]).view(bsz, s, kv, hd)
    if m.get("qk_norm"):
        q = _rms(q, lp["q_norm"], m["norm_eps"])
        k = _rms(k, lp["k_norm"], m["norm_eps"])
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, heads, S, hd]
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = mm(q, k.transpose(-1, -2).contiguous()) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(bsz, s, h * hd)
    x = x + proj(o, lp["wo"]).view(bsz, s, d)
    a = _norm(m, x, lp.get("ln2"))
    g, u = proj(a, lp["wg"]), proj(a, lp["wu"])
    return x + proj(F.silu(g) * u, lp["wd"]).view(bsz, s, d)


def _layer_params(params: dict, i: int) -> dict:
    out = {}
    for path, t in params.items():
        if path.startswith("layers/"):
            out[path.rsplit("/", 1)[1]] = t[i]
    return out


def forward(m: dict, params: dict, tokens: torch.Tensor, *, mode: str = "fp32",
            remat: bool = False) -> torch.Tensor:
    """Logits ``[B, S, V]`` (float32) of int tokens ``[B, S]``.  ``params``:
    ``{path: float32 tensor}``.  ``remat`` recomputes each layer in the
    backward (memory only: the values are the same)."""
    mm = matmul(mode)
    x = params["embed"][tokens.long()]
    for i in range(m["num_layers"]):
        lp = _layer_params(params, i)
        if remat:
            x = checkpoint(lambda t, lp=lp: _layer(m, lp, t, mm), x, use_reentrant=False)
        else:
            x = _layer(m, lp, x, mm)
    x = _norm(m, x, params.get("final_norm"))
    head = params["embed"].T if m.get("tie_embeddings") else params["lm_head"]
    bsz, s, d = x.shape
    return mm(x.reshape(-1, d), head).view(bsz, s, -1)

"""Tree verification: score a packed candidate tree in one pass and accept
the longest target-consistent root-to-leaf path (counterpart of
``repro.spec.tree``).

Packed-tree layout (what every host proposer emits):

  * ``parents`` -- a tuple of length N; ``parents[0] == -1`` (node 0 is the
    root: the slot's current, committed token) and ``parents[j] < j``, so
    any root-to-leaf path visits increasing node indices.  The topology is
    shared across the batch; token content is per slot.
  * node j's K/V occupies cache position ``index + j`` (the slot a linear
    chunk would use) while its RoPE position is ``index + depth(j)``.
  * ``anc[j]`` -- int32 bitmask of j's ancestors including j; N <= 31.

Greedy acceptance walks from the root: the child whose token equals the
target argmax at the current node extends the path (first child wins on
duplicate siblings).  The emitted tokens are the target argmaxes along the
path plus the bonus / correction at its end -- identical to plain greedy
decode, and to ``verify.greedy_accept`` on a chain.  The accepted path's
K/V is then compacted to contiguous positions ``index .. index + a``.

Only the paged target layout is ported: the dense one (``_compact_dense``)
comes with the dense target slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

#: int32 ancestor bitmasks bound the packed tree size.
MAX_TREE_NODES = 31


# ---------------------------------------------------------------------------
# Static topology helpers (plain Python over the parents tuple)
# ---------------------------------------------------------------------------


def validate_parents(parents: tuple) -> None:
    n = len(parents)
    if n < 1 or n > MAX_TREE_NODES:
        raise ValueError(f"tree must have 1..{MAX_TREE_NODES} nodes, got {n}")
    if parents[0] != -1:
        raise ValueError("node 0 must be the root (parents[0] == -1)")
    for j, p in enumerate(parents[1:], start=1):
        if not 0 <= p < j:
            raise ValueError(f"parents[{j}] = {p}: parents must precede children")


def linear_chain(gamma: int) -> tuple:
    """The chain topology: root + gamma nodes, each the previous one's
    child.  Tree verification over it is bit-identical to chunk verify."""
    return (-1,) + tuple(range(gamma))


def branching_tree(width: int, depth: int) -> tuple:
    """``width`` independent chains of ``depth`` nodes sharing the root."""
    parents = [-1]
    for _ in range(width):
        prev = 0
        for _ in range(depth):
            parents.append(prev)
            prev = len(parents) - 1
    return tuple(parents)


def tree_depths(parents: tuple) -> np.ndarray:
    """[N] int32 node depths (root = 0)."""
    validate_parents(parents)
    d = np.zeros(len(parents), np.int32)
    for j, p in enumerate(parents[1:], start=1):
        d[j] = d[p] + 1
    return d


def tree_ancestor_masks(parents: tuple) -> np.ndarray:
    """[N] int32 ancestor bitmasks (self bit set); a chain gives the causal
    triangle ``0b1, 0b11, 0b111, ...``."""
    validate_parents(parents)
    anc = np.zeros(len(parents), np.int32)
    anc[0] = 1
    for j, p in enumerate(parents[1:], start=1):
        anc[j] = anc[p] | (1 << j)
    return anc


# ---------------------------------------------------------------------------
# Acceptance
# ---------------------------------------------------------------------------


def tree_greedy_accept(
    parents: tuple,
    tree_tokens: torch.Tensor,  # [B, N] int32; node 0 = current token
    target_logits: torch.Tensor,  # [B, N, V]
    remaining: torch.Tensor,  # [B] int32 token budgets
    *,
    match: Optional[torch.Tensor] = None,  # [B, N] bool override (simulated)
):
    """Greedy root-to-leaf acceptance over a packed tree.

    Returns ``(a, nxt, out, a_match, path_idx)``: ``a`` the accepted
    candidate count (``a + 1 <= remaining``), ``nxt`` the next current
    token, ``out`` [B, D + 1] the emitted row (D = max depth; entries past
    ``a`` are 0), ``a_match`` the unclamped run, and ``path_idx`` [B, N] the
    node of the accepted path at each depth (identity past the path: the KV
    compaction map)."""
    b, n = tree_tokens.shape
    dev = tree_tokens.device
    depths = tree_depths(parents)
    d_max = int(depths.max())
    tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, N]
    if match is None:
        # node j extends the path iff its token is the target argmax at its
        # parent
        par = torch.tensor([max(p, 0) for p in parents], device=dev)
        match = tree_tokens == tgt[:, par]
    # walk in node order: a node is on the path iff its parent is, its token
    # matches, and no earlier sibling claimed the parent
    on = torch.zeros((b, n), dtype=torch.bool, device=dev)
    on[:, 0] = True
    claimed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for j in range(1, n):
        p = parents[j]
        ok = on[:, p] & match[:, j] & ~claimed[:, p]
        on[:, j] = ok
        claimed[:, p] |= ok
    a_match = on.sum(dim=1).to(torch.int32) - 1
    a = torch.clamp(torch.minimum(a_match, remaining - 1), 0, d_max).to(torch.int32)
    # path_at_depth[b, d]: the on-path node at depth d (0 past the leaf)
    depth_sel = torch.tensor(depths, device=dev)[None, :] == torch.arange(n, device=dev)[:, None]
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    on_ids = on.to(torch.int32) * node_ids[None, :]  # [B, N]
    path_at_depth = (on_ids[:, None, :] * depth_sel[None].to(torch.int32)).sum(dim=-1)
    jpos = torch.arange(d_max + 1, device=dev)[None, :]
    along = torch.gather(tgt, 1, path_at_depth[:, : d_max + 1].long())
    out = torch.where(jpos <= a[:, None], along, torch.zeros_like(along))
    nxt = torch.gather(along, 1, a[:, None].long())[:, 0]
    path_idx = torch.where(node_ids[None, :] <= a[:, None], path_at_depth,
                           node_ids[None, :].expand(b, n))
    return a, nxt, out, a_match, path_idx.to(torch.int32)


# ---------------------------------------------------------------------------
# KV path compaction
# ---------------------------------------------------------------------------


def _compact_paged(pool, block_tables, idx0, comp) -> None:
    """Gather the accepted path's rows through the block table and scatter
    them back at node-index positions ``idx0 .. idx0 + N - 1``, in place,
    over every layer at once.  pool: [L, P, page, kvH, hd]; comp [B, N]:
    source node of each destination slot (``comp >= slot``, and the gather
    is a copy taken before the scatter).  Positions past the table width
    clamp onto the sentinel column, as ``layers.paged_kv_write``."""
    n = comp.shape[1]
    page = pool.shape[2]
    w = block_tables.shape[1]
    bt = block_tables.long()

    def addr(pos):
        pos = pos.long()
        return torch.gather(bt, 1, torch.clamp(pos // page, max=w - 1)), pos % page

    src_pages, src_offs = addr(idx0[:, None] + comp)
    vals = pool[:, src_pages, src_offs]  # [L, B, N, kvH, hd]
    dst = idx0[:, None] + torch.arange(n, dtype=torch.int32, device=comp.device)[None, :]
    dst_pages, dst_offs = addr(dst)
    pool[:, dst_pages, dst_offs] = vals


def compact_accepted_path(cache, comp: torch.Tensor):
    """Rewrite every layer's chunk-region K/V so the accepted path is
    contiguous at ``index .. index + a`` (the index not yet advanced), in
    place.  ``comp`` [B, N] maps destination slot -> source node; inactive
    slots pass the identity map (a value-preserving rewrite)."""
    bt = cache.get("block_tables")
    if bt is None:
        raise NotImplementedError(
            "path compaction on a dense target cache is not ported yet"
        )
    for name in ("k", "v"):
        _compact_paged(cache["layers"][name], bt, cache["index"], comp)
    return cache


# ---------------------------------------------------------------------------
# The host-proposed tree-verify round
# ---------------------------------------------------------------------------


def tree_verify_round(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B] current tokens (the tree roots)
    cache,
    tail_tokens: torch.Tensor,  # [B, N - 1] proposed candidate tokens
    remaining: torch.Tensor,  # [B] int32 budgets
    *,
    parents: tuple,
    mode: str = "greedy",
    max_seq: int,
    sim_accept_p: float = 0.9,
    gen: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
):
    """ONE verify / accept round over a packed candidate tree from a host
    proposer: embed the N nodes, one tree-verify pass, accept the longest
    root-to-leaf path, compact its K/V, rewind the index.

    Returns ``(tokens, cache, remaining, out [B, D + 1], n_out [B],
    accepted [B], proposed [B], bad [B])`` -- the reference's tuple without
    its PRNG key -- with ``spec_round``'s freeze semantics and NaN screen.
    ``mode="simulated"`` draws the path-extension outcomes from ``gen``."""
    n = len(parents)
    validate_parents(parents)
    dev = tokens.device
    b = tokens.shape[0]
    depths = torch.tensor(tree_depths(parents), device=dev)
    anc = torch.tensor(tree_ancestor_masks(parents), device=dev).expand(b, n).contiguous()
    idx0 = cache["index"]
    active = (remaining > 0) & (idx0 + (n - 1) < max_seq)
    tree_tokens = torch.cat([tokens[:, None], tail_tokens.to(tokens.dtype)], dim=1)
    logits, cache, _ = T.decode_chunk(
        cfg, params, tree_tokens, cache, compute_dtype=compute_dtype,
        attn_impl=attn_impl, anc=anc, depths=depths,
    )
    bad = active & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
    if mode == "greedy":
        a, nxt, out, a_match, path_idx = tree_greedy_accept(
            parents, tree_tokens, logits, remaining
        )
    elif mode == "simulated":
        if gen is None:
            raise ValueError("simulated tree verification needs a torch.Generator")
        match = torch.rand((b, n), generator=gen, device=dev) < sim_accept_p
        a, nxt, out, a_match, path_idx = tree_greedy_accept(
            parents, tree_tokens, logits, remaining, match=match
        )
    else:
        raise ValueError(f"unknown tree verification mode {mode!r}")

    # decode_chunk advanced the index by N: rebase before compaction + rewind
    cache = dict(cache, index=idx0)
    ident = torch.arange(n, dtype=torch.int32, device=dev)[None, :].expand(b, n)
    compact_accepted_path(cache, torch.where(active[:, None], path_idx, ident))
    n_out = torch.where(active, a + 1, torch.zeros_like(a))
    cache = dict(cache, index=torch.where(active, idx0 + a + 1, idx0).to(torch.int32))
    tokens = torch.where(active, nxt, tokens)
    remaining = remaining - n_out
    out = torch.where(active[:, None], out, torch.zeros_like(out))
    accepted = torch.where(active, a_match, torch.zeros_like(a_match))
    proposed = active.to(torch.int32) * (n - 1)
    return tokens, cache, remaining, out, n_out, accepted, proposed, bad

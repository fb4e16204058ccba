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
K/V is then compacted to contiguous positions ``index .. index + a``, on
the paged or the dense target layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
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


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """A topology's device constants, built once outside a round (a round
    captured as a CUDA graph may not turn host data into tensors): ``par``
    [N] each node's parent (the root its own), ``depths`` [N] int32,
    ``anc`` [B, N] int32 ancestor bitmasks, ``depth_sel`` [N, N] bool
    (``depth_sel[d, j]``: node j sits at depth d)."""

    par: torch.Tensor
    depths: torch.Tensor
    anc: torch.Tensor
    depth_sel: torch.Tensor


def tree_topology(parents: tuple, batch: int, device) -> TreeTopology:
    """``parents``' device constants for a batch of ``batch`` slots."""
    n = len(parents)
    depths = torch.tensor(tree_depths(parents), device=device)
    anc = torch.tensor(tree_ancestor_masks(parents), device=device)
    return TreeTopology(
        par=torch.tensor([max(p, 0) for p in parents], device=device),
        depths=depths,
        anc=anc.expand(batch, n).contiguous(),
        depth_sel=depths[None, :] == torch.arange(n, device=device)[:, None],
    )


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
    topo: Optional[TreeTopology] = None,
):
    """Greedy root-to-leaf acceptance over a packed tree.

    Returns ``(a, nxt, out, a_match, path_idx)``: ``a`` the accepted
    candidate count (``a + 1 <= remaining``), ``nxt`` the next current
    token, ``out`` [B, D + 1] the emitted row (D = max depth; entries past
    ``a`` are 0), ``a_match`` the unclamped run, and ``path_idx`` [B, N] the
    node of the accepted path at each depth (identity past the path: the KV
    compaction map).  ``topo``: ``parents``' device constants
    (``tree_topology``; built here when None)."""
    b, n = tree_tokens.shape
    dev = tree_tokens.device
    if topo is None:
        topo = tree_topology(parents, b, dev)
    d_max = int(tree_depths(parents).max())
    tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, N]
    if match is None:
        # node j extends the path iff its token is the target argmax at its
        # parent
        match = tree_tokens == tgt[:, topo.par]
    # walk in node order: a node is on the path iff its parent is, its token
    # matches, and no earlier sibling claimed the parent
    on = torch.zeros((b, n), dtype=torch.bool, device=dev)
    on[:, 0].fill_(True)  # (a fill, not a Python value turned into a tensor)
    claimed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for j in range(1, n):
        p = parents[j]
        ok = on[:, p] & match[:, j] & ~claimed[:, p]
        on[:, j] = ok
        claimed[:, p] |= ok
    a_match = on.sum(dim=1).to(torch.int32) - 1
    a = torch.clamp(torch.minimum(a_match, remaining - 1), 0, d_max).to(torch.int32)
    # path_at_depth[b, d]: the on-path node at depth d (0 past the leaf)
    depth_sel = topo.depth_sel
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
    clamp onto the sentinel column, and rows that collide there keep the
    last one's value, as ``layers.paged_kv_write``."""
    b, n = comp.shape
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
    src = L.last_writers((dst_pages * page + dst_offs).reshape(-1), pool.shape[1] * page)
    vals = vals.reshape(pool.shape[0], b * n, *vals.shape[3:])[:, src]
    pool[:, dst_pages, dst_offs] = vals.reshape(pool.shape[0], b, n, *vals.shape[2:])


def _compact_dense(kc, idx0, comp) -> None:
    """Gather the accepted path's rows to contiguous rows, in place, over
    every layer at once.  kc: [L, B, S, kvH, hd]; comp [B, N]: source node of
    each destination slot.  As the reference: the source row
    ``idx0 + comp`` clamps to S - 1, and the N destination rows start at
    ``idx0`` clamped into [0, S - N] (``dynamic_update_slice``); the gather
    is a copy taken before the scatter."""
    b, n = comp.shape
    s = kc.shape[2]
    rows = torch.arange(b, device=comp.device)[:, None]
    src = torch.clamp(idx0[:, None] + comp, max=s - 1).long()
    vals = kc[:, rows, src]  # [L, B, N, kvH, hd]
    start = idx0.long().clamp(0, s - n)
    kc[:, rows, start[:, None] + torch.arange(n, device=comp.device)[None, :]] = vals


def compact_accepted_path(cache, comp: torch.Tensor):
    """Rewrite every layer's chunk-region K/V so the accepted path is
    contiguous at ``index .. index + a`` (the index not yet advanced), in
    place, on the paged or the dense layout.  ``comp`` [B, N] maps
    destination slot -> source node; inactive slots pass the identity map
    (a value-preserving rewrite)."""
    bt = cache.get("block_tables")
    for name in ("k", "v"):
        if bt is None:
            _compact_dense(cache["layers"][name], cache["index"], comp)
        else:
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
    topo: Optional[TreeTopology] = None,
):
    """ONE verify / accept round over a packed candidate tree from a host
    proposer: embed the N nodes, one tree-verify pass, accept the longest
    root-to-leaf path, compact its K/V, rewind the index.

    Returns ``(tokens, cache, remaining, out [B, D + 1], n_out [B],
    accepted [B], proposed [B], bad [B])`` -- the reference's tuple without
    its PRNG key -- with ``spec_round``'s freeze semantics and NaN screen.
    ``mode="simulated"`` draws the path-extension outcomes from ``gen``.
    ``topo``: ``parents``' device constants (``tree_topology``), which a
    round captured as a CUDA graph takes from outside; built here when
    None."""
    n = len(parents)
    validate_parents(parents)
    dev = tokens.device
    b = tokens.shape[0]
    if topo is None:
        topo = tree_topology(parents, b, dev)
    idx0 = cache["index"]
    active = (remaining > 0) & (idx0 + (n - 1) < max_seq)
    tree_tokens = torch.cat([tokens[:, None], tail_tokens.to(tokens.dtype)], dim=1)
    logits, cache, _ = T.decode_chunk(
        cfg, params, tree_tokens, cache, compute_dtype=compute_dtype,
        attn_impl=attn_impl, anc=topo.anc, depths=topo.depths,
    )
    bad = active & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
    if mode == "greedy":
        a, nxt, out, a_match, path_idx = tree_greedy_accept(
            parents, tree_tokens, logits, remaining, topo=topo
        )
    elif mode == "simulated":
        if gen is None:
            raise ValueError("simulated tree verification needs a torch.Generator")
        match = torch.rand((b, n), generator=gen, device=dev) < sim_accept_p
        a, nxt, out, a_match, path_idx = tree_greedy_accept(
            parents, tree_tokens, logits, remaining, match=match, topo=topo
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

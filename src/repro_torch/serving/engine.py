"""Continuous-batching greedy inference engine, with speculative decoding.

Counterpart of ``repro.serving.engine.InferenceEngine``, for the dense,
Mixture-of-Experts, Mamba1, Zamba2 hybrid, audio and VLM families.  Two KV
layouts (``kv_page_size``): by default (the attention families: dense, MoE,
audio and VLM) KV lives in a shared pool of 16-token physical pages addressed through
per-slot block tables (``serving/kv_pool.py``), admission reserves a slot's
worst-case pages and a radix tree serves shared page-aligned prefixes from
cached pages; ``kv_page_size=0`` (always for the recurrent families, Mamba1
and the hybrid) keeps dense ``[B, S_max]`` rows per slot (Mamba1: its conv
and SSM state; the hybrid: its Mamba2 state and the shared block's K/V
rows).  Two prefill modes (``prefill_chunk``): by default (attention
families) the prompt streams as fixed 32-token chunks through ONE batched
prefill program per wave; ``prefill_chunk=0`` (always for the recurrent
families) prefills the whole prompt at admission, zero-padded to a
power-of-two bucket (``prefill_into_slot``; on a radix hit only the
suffix, through the paged verify pass).  Decode runs
``k`` greedy microsteps per dispatch with a single device -> host fetch at
the end.  ``decode_microstep`` is the reference's single-step path (one
``T.decode_step`` and its argmax, one fetch a step).

On CUDA with the kernels (``graphs``) every program the reference compiles
with ``jax.jit`` is a CUDA graph, captured at its first call and replayed
(``serving/graphs.py``), since its eager form is paced by the host's
launches of thousands of small ops: the decode loop per ``k`` on every
layout and family, the ONE chunked-prefill program per model (target and
draft: every argument a tensor, so one capture serves every mix of slots,
chunk lengths and offsets), the bucket and suffix prefills per model and
bucket width (slot and lengths are device tensors), the fused spec loop
per ``(k, gamma)``, the host-proposed tree round per ``(parents, mode)``
(``_tree_round_fn``: the gamma and width buckets bound the topologies) and
``decode_microstep``'s single step.  ``prefill_compile_count`` /
``prefill_compile_counts()`` count the prefill programs by the reference's
rule on every device; on CUDA each is one captured graph.  The CPU runs
every program eagerly.

Speculation (``spec``): a ``draft_cfg`` / ``draft_params`` pairing keeps the
draft model in a dense cache (``T.init_cache``) whose prompt streams through
the same chunk waves, and ``_drive_spec_loop(k, gamma)`` runs k fused
draft-propose / chunk-verify rounds that emit up to ``gamma + 1`` verified
tokens per slot.  Host proposers (n-gram, static suffix) instead verify a
packed candidate tree per round (``_drive_proposed_loop``), and an
acceptance-EWMA router picks the proposer per quantum.

The engine keeps the compute primitives (``_admit_request``, the chunk
waves, ``_drive_decode_loop``, ``_drive_spec_loop``,
``_drive_proposed_loop``, ``evict_slot``); the request lifecycle lives in
``serving/core.py`` (``EngineCore``), which the ``core`` property builds.

Fault containment (``repro_torch.resilience``): a seeded ``fault_injector``
is consulted at ``engine/nan_logits`` before each fused dispatch (one
decodable slot's last written K is poisoned) and handed to the page pool for
``pool/alloc_fail``.  A slot whose logits come back non-finite is quarantined
(its private KV scrubbed, the slot evicted, the request re-queued with
backoff by the core); a failed top-up allocation evicts and re-queues that
slot alone.  Every such write lands in place in the pool tensors, which a
captured decode graph reads at the addresses it recorded.

The device is ``cuda`` unless the caller passes ``device="cpu"``; without a
CUDA device and without an explicit ``device="cpu"`` the constructor raises.
On CUDA the attention cores launch the hand-written kernels, on the CPU their
plain PyTorch versions.  The KV pool, block tables, indices and token vector
are updated in place (the reference's jit donates them).

The MoE family routes each decode step's tokens as ONE group across every
slot (``models/moe.py``): through expert capacity a slot's tokens depend on
the other slots' tokens, idle and PREFILLING slots included, so the engine
keeps the reference's token vector and decodes every slot, never a
compacted batch.

The audio and VLM families (``embed_inputs``) serve token prompts through
the reference's stub frontend: a monolithic prefill (target and draft)
feeds the bucket's rows of the embedding table as precomputed embeddings
(``_embed_or_pass``); chunked and suffix prefill, decode and verify take
the token ids, as in the reference.

Speculation pairs any target with any draft of its vocabulary, as the
reference's: a recurrent (Mamba1 or hybrid) target verifies a draft chunk
by ``decode_step`` T times, and a recurrent target or draft rolls its state
back from the per-step copies (``spec.rollback``).  Host proposers need an
attention target (tree verification), so ``proposer="ngram"`` or
``"auto"`` registers no n-gram lookup on a recurrent one; a draft that
streams chunked prefill needs an attention family too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SpecDecodeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import Observability
from repro_torch.serving.graphs import GraphProgram, pool_bytes
from repro_torch.serving.kv_pool import PageAllocError, PagePool, RadixCache
from repro_torch.spec import tree as spec_tree
from repro_torch.spec.loop import spec_decode_loop
from repro_torch.spec.proposers import (
    DraftModelProposer,
    NgramProposer,
    ProposeContext,
    ProposerRouter,
)
from repro_torch.tree import tree_leaves

_req_counter = itertools.count()


def advance_request_ids(floor: int) -> None:
    """Future auto-assigned request ids are ``>= floor`` (journal recovery
    re-creates requests under their journaled ids)."""
    global _req_counter
    nxt = next(_req_counter)
    _req_counter = itertools.count(max(nxt, int(floor)))


#: Fused-loop sizes callers pick their k from (the reference bounds its
#: compiled programs with them; the schedule is kept identical).
DECODE_K_BUCKETS = (1, 2, 4, 8)

#: Physical page size (tokens) of the paged KV pool.
DEFAULT_KV_PAGE_SIZE = 16

#: Chunked-prefill width (tokens per slot per wave).
DEFAULT_PREFILL_CHUNK = 32

#: Smallest monolithic prefill bucket (rounded up to a page when paged).
MIN_PREFILL_BUCKET = 8

#: families whose layers hold attention (paged KV and chunked prefill apply)
_ATTENTION_FAMILIES = T.ATTENTION_FAMILIES


class RegistryCounterView:
    """A historical ``InferenceEngine`` counter attribute backed by a
    registry counter under a stable name: ``engine.d2h_transfers += 1`` and
    ``engine.obs.metrics.counter("engine/d2h_transfers")`` are the SAME
    cell.  The counter object is cached on the instance after first use."""

    def __init__(self, name: str):
        self.name = name
        self._cache_attr = "_ctr_" + name.replace("/", "_")

    def _cell(self, obj):
        cell = getattr(obj, self._cache_attr, None)
        if cell is None:
            cell = obj.obs.metrics.counter(self.name)
            setattr(obj, self._cache_attr, cell)
        return cell

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._cell(obj).value

    def __set__(self, obj, value):
        self._cell(obj).set(value)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # [prompt_len] int32
    max_new_tokens: int
    #: submission spec read by ``SpecInFRuntime(online_requests=...)``
    arrival_time: float = 0.0
    online: bool = False
    request_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    # -- filled by the engine --
    generated: list = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None


class InferenceEngine:
    # Counter attributes, thin views over the metrics registry (the
    # reference's stable names).
    d2h_transfers = RegistryCounterView("engine/d2h_transfers")
    steps_executed = RegistryCounterView("engine/steps_executed")
    generated_tokens_total = RegistryCounterView("engine/generated_tokens")
    prefill_prompt_tokens = RegistryCounterView("engine/prefill_prompt_tokens")
    prefill_skipped_tokens = RegistryCounterView("engine/prefill_skipped_tokens")
    prefill_metered_tokens = RegistryCounterView("engine/prefill_metered_tokens")
    spec_rounds = RegistryCounterView("engine/spec_rounds")
    spec_drafted = RegistryCounterView("engine/spec_drafted")
    spec_accepted = RegistryCounterView("engine/spec_accepted")

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        max_slots: int = 4,
        max_seq: int = 128,
        compute_dtype: torch.dtype = torch.bfloat16,
        decode_impl: str = "auto",
        clock: Optional[Callable[[], float]] = None,
        device: Optional[str | torch.device] = None,
        draft_cfg: Optional[ModelConfig] = None,
        draft_params: Any = None,
        spec: Optional[SpecDecodeConfig] = None,
        kv_page_size: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        kv_pool_pages: Optional[int] = None,
        fault_injector=None,
    ):
        """``kv_page_size``: None -> 16 for attention families, 0 (dense rows)
        otherwise; ``prefill_chunk``: None -> 32 for attention families, 0
        (monolithic bucket prefill) otherwise; ``kv_pool_pages``: None -> the
        dense-equivalent capacity plus the sentinel page (a smaller pool can
        run out, and admission then waits).  ``fault_injector`` arms the
        fault points (``repro_torch.resilience.FaultInjector``; None is
        inert).

        ``decode_impl`` picks the kernels of every pass ("auto" | "cuda" |
        "torch", as ``kernels.ops``): decode, chunked and monolithic prefill
        (attention and the SSM scan) and verify.  "auto" is the kernel for
        CUDA tensors; the reference splits off a ``prefill_impl`` whose
        default "xla" skips its prefill kernels, and its scan takes the
        kernel only under "pallas"."""
        if cfg.family not in T.FAMILIES:
            raise ValueError(f"the port serves the {T.FAMILIES} families, not {cfg.family!r}")
        attention = cfg.family in _ATTENTION_FAMILIES
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params without draft_cfg")
        # the counter views' cells live in ``self.obs.metrics``: build it first
        self.obs = Observability()
        self.fault_injector = fault_injector
        if fault_injector is not None:
            fault_injector.metrics = self.obs.metrics
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.compute_dtype = compute_dtype
        # weights cast once to the compute dtype (the reference casts inside
        # every jitted step; the in-step cast is then a no-op)
        self.params = T.cast_params(
            _to_device(params, self.device), compute_dtype
        )
        self.clock: Callable[[], float] = clock or time.monotonic
        self.attn_impl = decode_impl
        #: the captured programs by key (``graphs``): ("decode", k),
        #: ("spec", k, gamma), ("chunk", model), ("bucket", model, width),
        #: ("suffix", "target", width), ("tree", parents, mode), ("step",);
        #: dropped when a cache tensor moves
        self._graphs: dict = {}
        self._graph_ptrs: tuple = ()
        self._graph_pool = self._graph_stream = None
        #: (parents, mode) -> the tree round's program (``_tree_round_fn``)
        self._tree_round_cache: dict = {}
        #: warm-up keys done: one warm-up a set of kernels and shapes
        self._warmed: set = set()
        #: (model, impl) -> bucket widths of the prefill programs run (the
        #: reference's ``_prefill_programs``)
        self._prefill_programs: dict = {}
        self.min_prefill_bucket = MIN_PREFILL_BUCKET

        if prefill_chunk is None:
            prefill_chunk = DEFAULT_PREFILL_CHUNK if attention else 0
        if prefill_chunk and not attention:
            raise ValueError(f"chunked prefill needs an attention family, not {cfg.family!r}")
        if prefill_chunk and draft_params is not None and (
                draft_cfg.family not in _ATTENTION_FAMILIES):
            # the reference's chunk program asserts this at the first wave
            raise ValueError(f"chunked prefill needs an attention draft, not "
                             f"{draft_cfg.family!r} (pass prefill_chunk=0)")
        self.prefill_chunk = prefill_chunk
        #: per-slot prompt tokens still to stream while PREFILLING (target and
        #: draft progress differ under prefix hits: the draft has no prefix
        #: pool and always streams the whole prompt)
        self._prefill_left: list[Optional[np.ndarray]] = [None] * max_slots
        self._draft_prefill_left: list[Optional[np.ndarray]] = [None] * max_slots
        #: device [B] next-token vector of the wave that completed each
        #: slot's prefill, fetched in ONE batched transfer at completion
        self._prefill_tok: list = [None] * max_slots
        #: slot -> metered tokens taken by the LAST _drive_prefill_chunks
        self.last_prefill_slot_tokens: dict[int, int] = {}

        # --- KV layout: paged pool (attention families) or dense rows ---
        if kv_page_size is None:
            kv_page_size = DEFAULT_KV_PAGE_SIZE if attention else 0
        self.paged = kv_page_size > 0
        self.kv_page_size = kv_page_size
        self.pool: Optional[PagePool] = None
        self.prefix_cache: Optional[RadixCache] = None
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._slot_reserved = [0] * max_slots
        self._slot_idx = [0] * max_slots
        self._slot_horizon = [0] * max_slots
        self._bt_dirty = False
        if self.paged:
            if not attention:
                raise ValueError(f"paged KV needs an attention family, not {cfg.family!r}")
            if kv_page_size & (kv_page_size - 1):
                raise ValueError("kv_page_size must be a power of two")
            self.pages_per_slot = -(-max_seq // kv_page_size)
            # dense-equivalent logical capacity plus the sentinel page
            num_pages = kv_pool_pages or max_slots * self.pages_per_slot + 1
            self.pool = PagePool(num_pages, kv_page_size)
            self.pool.fault_injector = fault_injector
            self.prefix_cache = RadixCache(self.pool)
            self.cache = T.init_paged_cache(
                cfg, max_slots, num_pages, kv_page_size, self.pages_per_slot,
                compute_dtype, self.device,
            )
            # monolithic buckets stay page-aligned for the page scatter
            self.min_prefill_bucket = kv_page_size * (
                -(-MIN_PREFILL_BUCKET // kv_page_size)
            )
            # host mirror of the device block tables: mutations land here and
            # ship as ONE whole-table host -> device copy
            self._bt_host = np.zeros((max_slots, self.pages_per_slot + 1), np.int32)
        else:
            self.cache = T.init_cache(cfg, max_slots, max_seq, compute_dtype, self.device)

        self._core = None  # lazily-built EngineCore (the .core property)
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.steps_executed = 0
        self.d2h_transfers = 0
        self.generated_tokens_total = 0
        self.prefill_prompt_tokens = 0
        self.prefill_skipped_tokens = 0
        self.prefill_metered_tokens = 0
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

        # --- speculative decoding (draft / target pairing) ---------------
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.draft_cache = None
        self.spec_cfg = spec or SpecDecodeConfig()
        #: draws of the random speculative modes (spec loop and tree rounds)
        self._spec_gen = torch.Generator(device=self.device).manual_seed(0)
        if draft_params is not None:
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            self.draft_params = T.cast_params(
                _to_device(draft_params, self.device), compute_dtype
            )
            self.draft_cache = T.init_cache(
                draft_cfg, max_slots, max_seq, compute_dtype, self.device
            )

        # --- pluggable proposers + routing -------------------------------
        #: ``spec_cfg.proposer``: "auto" registers the draft model and (on an
        #: attention family) the n-gram lookup on a draft-paired engine
        #: (nothing on a plain one); "draft" / "ngram" pin one ("ngram"
        #: speculates without a draft model; on a recurrent family it
        #: registers nothing and the engine decodes plainly, as the
        #: reference's); "none" disables routing
        self._proposers: dict = {}
        self._router: Optional[ProposerRouter] = None
        #: per-slot (accepted, proposed) of the LAST fused spec loop
        self._last_spec_slot_stats: dict = {}
        pchoice = self.spec_cfg.proposer
        if pchoice != "none":
            if self.spec_enabled and pchoice in ("auto", "draft"):
                self._proposers["draft"] = DraftModelProposer(
                    draft_cost_ratio=self.spec_cfg.draft_cost_ratio
                )
            if attention and (pchoice == "ngram" or (pchoice == "auto" and self.spec_enabled)):
                self._proposers["ngram"] = NgramProposer(
                    order=self.spec_cfg.ngram_order
                )
            if self._proposers:
                self._rebuild_router()

    # ------------------------------------------------------------------
    @property
    def spec_enabled(self) -> bool:
        """True with a draft pairing."""
        return self.draft_params is not None

    @property
    def host_spec_enabled(self) -> bool:
        """True when a host (model-free) proposer is registered: tree
        verification runs even without a draft pairing."""
        return any(p.kind == "host" for p in self._proposers.values())

    @property
    def proposer_router(self) -> Optional[ProposerRouter]:
        return self._router

    def register_proposer(self, proposer) -> None:
        """Attach another candidate source (e.g. a corpus-backed
        ``StaticSuffixProposer``) and rebuild the router over the new set.
        Host proposers need an attention family (tree verification needs
        parallel position scoring), as the reference asserts."""
        if proposer.kind == "host" and self.cfg.family not in _ATTENTION_FAMILIES:
            raise ValueError(f"host proposers need an attention family, not "
                             f"{self.cfg.family!r}")
        self._proposers[proposer.name] = proposer
        self._rebuild_router()

    def _rebuild_router(self) -> None:
        self._router = ProposerRouter(
            list(self._proposers),
            device_names=tuple(
                n for n, p in self._proposers.items() if p.kind == "device"
            ),
            ewma=self.spec_cfg.router_ewma,
            init_acceptance=self.spec_cfg.router_init_acceptance,
            draft_cost_ratio=self.spec_cfg.draft_cost_ratio,
        )

    def route_proposer(self, gamma: int) -> Optional[str]:
        """ONE proposer for the coming quantum's batch, by summed per-slot
        score; None when no proposer is registered."""
        if self._router is None:
            return None
        slots = [
            i for i, r in enumerate(self.slots)
            if r is not None and not self.slot_prefilling(i)
        ]
        name = self._router.pick_majority(slots, gamma)
        self.obs.metrics.counter("spec/proposer/router_switches").set(
            self._router.switches
        )
        return name

    def proposer_round_cost(self, name: str, gamma: int) -> float:
        """Quantum steps one routed round spends (grant pricing)."""
        return self._router.round_cost(name, gamma)

    @property
    def spec_acceptance_rate(self) -> float:
        """Draft-token acceptance over every spec round (before the budget
        clamp: draft quality, not budget truncation)."""
        if self.spec_drafted == 0:
            return float("nan")
        return self.spec_accepted / self.spec_drafted

    # ------------------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def slot_prefilling(self, i: int) -> bool:
        """True while slot ``i`` still has prompt chunks to stream (target or
        draft side); such a slot is frozen in the fused loops and never
        retires mid-prefill."""
        return (
            self._prefill_left[i] is not None
            or self._draft_prefill_left[i] is not None
        )

    @property
    def num_prefilling(self) -> int:
        return sum(self.slot_prefilling(i) for i in range(self.max_slots))

    # ------------------------------------------------------------------
    # Paged-pool bookkeeping
    # ------------------------------------------------------------------
    def _page_need(self, req: Request) -> tuple[int, int]:
        """(worst-case total pages, prompt pages) for ``req``."""
        n = len(req.prompt)
        horizon = min(n + req.max_new_tokens, self.max_seq)
        return self.pool.pages_for(horizon), self.pool.pages_for(n)

    def _shared_prefix(self, prompt: np.ndarray, record: bool = True):
        """Longest radix-cached full-page prefix of ``prompt``, capped one
        token short of the whole prompt so at least one token remains to
        produce the first-token logits."""
        return self.prefix_cache.match(prompt[: len(prompt) - 1], record=record)

    def _ensure_capacity(self, need: int) -> bool:
        """Make ``need`` pages promisable, evicting LRU cached prefixes."""
        while self.pool.available < need:
            if self.prefix_cache.evict(need - self.pool.available) == 0:
                return False
        return True

    def request_fits(self, req: Request) -> bool:
        """Could ``req`` EVER be admitted, even on an idle engine?  False
        means waiting will not help (prompt beyond max_seq, or worst-case
        page need beyond the whole pool)."""
        if len(req.prompt) > self.max_seq:
            return False
        if not self.paged:
            return True
        total_pages, _ = self._page_need(req)
        return total_pages <= self.pool.num_pages - 1

    def can_admit(self, req: Request) -> bool:
        """Capacity probe: a free slot exists AND (paged) the pool can cover
        the request's worst-case page need, counting evictable cached
        prefixes but never the pages the request itself would share.
        Non-mutating."""
        if not self.free_slots() or not self.request_fits(req):
            return False
        if not self.paged:
            return True
        total_pages, _ = self._page_need(req)
        prompt = np.asarray(req.prompt, np.int32)
        shared = self._shared_prefix(prompt, record=False)
        evictable = self.prefix_cache.evictable_pages() - sum(
            1 for p in shared if self.pool.refcount[p] == 1
        )
        return total_pages - len(shared) <= self.pool.available + evictable

    def export_prefix_pages(self):
        """Warm-state snapshot export: the radix cache's nodes with the KV
        of their pages, ``(nodes, k, v)`` with ``k`` / ``v`` shaped
        ``[L, N, page, kvH, hd]`` in node order.  None on a dense engine or
        an empty cache."""
        if self.prefix_cache is None:
            return None
        nodes = self.prefix_cache.export_nodes()
        if not nodes:
            return None
        idx = torch.tensor([page for _, _, page in nodes], device=self.device)
        layers = self.cache["layers"]
        return nodes, layers["k"][:, idx], layers["v"][:, idx]

    def import_prefix_pages(self, nodes, k, v) -> int:
        """Warm the radix cache from an exported snapshot: allocate fresh
        pages (evicting colder entries if needed), copy the saved KV into
        them IN PLACE (a captured decode graph reads the pools where they
        live) and rebuild the tree.  Nodes that do not fit are dropped from
        the tail (parents come first, so a prefix is still a forest).
        Returns the nodes loaded."""
        if self.prefix_cache is None or not nodes:
            return 0
        keep = len(nodes)
        if not self._ensure_capacity(keep):
            keep = self.pool.available
            nodes = nodes[:keep]
        if keep == 0:
            return 0
        pages = self.pool.alloc(keep)
        idx = torch.tensor(pages, device=self.device)
        layers = self.cache["layers"]
        for name, src in (("k", k), ("v", v)):
            dst = layers[name]
            dst.index_copy_(1, idx, torch.as_tensor(src[:, :keep]).to(dst.device, dst.dtype))
        return self.prefix_cache.load_nodes(nodes, pages)

    def _sync_block_tables(self) -> None:
        # a copy: the device table must not alias the host mirror
        self.cache["block_tables"] = torch.tensor(self._bt_host, device=self.device)
        self._bt_dirty = False

    def _top_up_pages(self, steps: int) -> None:
        """Extend every active slot's block table to cover its next
        ``steps`` token writes, turning admission reservations into pages,
        so the decode loop never needs a host allocation.  A ``PageAllocError``
        (an injected allocator fault) evicts that slot alone and re-queues its
        request through the core's fault path."""
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            cover = min(self._slot_idx[i] + steps, self._slot_horizon[i])
            need = self.pool.pages_for(cover)
            cur = len(self._slot_pages[i])
            if need > cur:
                try:
                    got = self.pool.alloc(need - cur, reserved=True)
                except PageAllocError:
                    self.obs.metrics.counter("fault/alloc_failures").inc()
                    req = self.evict_slot(i, sync=False)
                    if self._core is not None:
                        self._core._on_slot_fault(i, req)
                    continue
                self._slot_reserved[i] -= len(got)
                self._bt_host[i, cur: cur + len(got)] = got
                self._slot_pages[i].extend(got)
                self._bt_dirty = True
        if self._bt_dirty:
            self._sync_block_tables()

    def _trim_slot_pages(self, i: int) -> None:
        """Release pages past the page holding the slot's next write position:
        what speculative rollback freed returns to the pool as restored
        reservation.  Marks the block tables dirty; the caller syncs once."""
        keep = self._slot_idx[i] // self.kv_page_size + 1
        pages = self._slot_pages[i]
        if len(pages) <= keep:
            return
        drop = pages[keep:]
        del pages[keep:]
        freed = self.pool.decref(drop)
        # trimmed pages sit past the prompt, so the radix tree never holds them
        assert len(freed) == len(drop), "trimmed a shared page"
        self.pool.reserve(len(drop))
        self._slot_reserved[i] += len(drop)
        self._bt_host[i, keep: keep + len(drop)] = 0
        self._bt_dirty = True

    def evict_slot(self, i: int, sync: bool = True) -> Request:
        """Release slot ``i`` -- pages back to the pool (paged), both cache
        indices reset -- WITHOUT finishing the request (the preempt/abort
        primitive; resume re-prefills ``prompt + generated``, on the paged
        layout mostly from radix-cached pages).  ``sync=False`` defers the
        block-table upload to the caller."""
        req = self.slots[i]
        assert req is not None, f"evict of empty slot {i}"
        self.slots[i] = None
        if self._router is not None:
            self._router.reset_slot(i)  # a recycled slot starts optimistic
        self._prefill_left[i] = None
        self._draft_prefill_left[i] = None
        self._prefill_tok[i] = None
        self.cache["index"][i] = 0
        if self.spec_enabled:
            self.draft_cache["index"][i] = 0
        self._slot_idx[i] = 0
        if self.paged:
            self.pool.decref(self._slot_pages[i])
            self.pool.unreserve(self._slot_reserved[i])
            self._slot_pages[i] = []
            self._slot_reserved[i] = 0
            self._slot_horizon[i] = 0
            self._bt_host[i] = 0
            self._bt_dirty = True
            if sync:
                self._sync_block_tables()
        return req

    def _retire_slot(self, i: int, now: float) -> Request:
        """Evict the slot, stamp the finish time, and notify the lifecycle
        core (if attached) so the request advances to FINISHED."""
        req = self.evict_slot(i, sync=False)
        req.finish_time = now
        if self._core is not None:
            self._core._on_slot_finished(i, req)
        return req

    def _paged_reserve(self, slot: int, req: Request) -> Optional[int]:
        """Paged admission bookkeeping, shared by chunked and monolithic
        prefill: match the radix prefix, make room (evicting LRU cached
        prefixes if needed), allocate the prompt pages and reserve the
        decode horizon.  Returns the shared token count, or None on
        capacity.  Leaves the block tables dirty for one batched upload."""
        n = len(req.prompt)
        prompt = np.asarray(req.prompt, np.int32)
        total_pages, prompt_pages = self._page_need(req)
        shared_pages = self._shared_prefix(prompt)
        if shared_pages:
            # hold the matched pages before eviction can reclaim them
            self.pool.incref(shared_pages)
        if not self._ensure_capacity(total_pages - len(shared_pages)):
            if shared_pages:
                self.pool.decref(shared_pages)
            return None
        try:
            new_pages = self.pool.alloc(prompt_pages - len(shared_pages))
        except PageAllocError:
            # exhaustion or an injected allocator fault: admission blocks
            self.obs.metrics.counter("fault/alloc_failures").inc()
            if shared_pages:
                self.pool.decref(shared_pages)
            return None
        self.pool.reserve(total_pages - prompt_pages)
        row = shared_pages + new_pages
        self._slot_pages[slot] = list(row)
        self._slot_reserved[slot] = total_pages - prompt_pages
        self._slot_horizon[slot] = min(n + req.max_new_tokens, self.max_seq)
        shared = len(shared_pages) * self.kv_page_size
        self._slot_idx[slot] = shared
        self._bt_host[slot] = 0
        self._bt_host[slot, : len(row)] = row
        self._bt_dirty = True
        return shared

    # ------------------------------------------------------------------
    # Chunked prefill: admission reserves, waves stream
    # ------------------------------------------------------------------
    def _begin_chunked_admit(self, slot: int, req: Request) -> bool:
        """Reserve the slot's capacity (prompt pages + decode-horizon
        reservation, radix prefix matched and held) WITHOUT prefill compute;
        the prompt then streams in ``_drive_prefill_chunks`` waves.  The
        dense layout has nothing to reserve."""
        shared = 0
        if self.paged:
            shared = self._paged_reserve(slot, req)
            if shared is None:
                return False
            if shared:
                # device progress starts past the radix-covered prefix, whose
                # pages chunk attention reads directly
                self.cache["index"][slot] = shared
        prompt = np.asarray(req.prompt, np.int32)
        self._prefill_left[slot] = prompt[shared:]
        if self.spec_enabled:
            self._draft_prefill_left[slot] = prompt  # no draft prefix pool
        self._prefill_tok[slot] = None
        self.prefill_prompt_tokens += len(req.prompt)
        self.prefill_skipped_tokens += shared
        self.slots[slot] = req
        return True

    def _plan_prefill_waves(self, budget: float):
        """Host-side preview of ``_drive_prefill_chunks``: greedy allocation
        of chunk takes, wave by wave, shortest pending stream first, under
        ``budget`` metered tokens (per slot per wave: the larger of the
        target and draft takes).  Returns ``(waves, consumed, completing)``
        with each wave a list of ``(slot, target_take, draft_take)``;
        deterministic, so a scheduler can price a step's prefill before
        driving it."""
        chunk = self.prefill_chunk
        left: dict[int, list[int]] = {}
        for i in range(self.max_slots):
            t, d = self._prefill_left[i], self._draft_prefill_left[i]
            t_n = len(t) if t is not None else 0
            d_n = len(d) if d is not None else 0
            if t_n or d_n:
                left[i] = [t_n, d_n]
        waves, consumed, completing = [], 0, []
        budget_left = budget
        while left:
            wave = []
            for i in sorted(left, key=lambda i: (max(left[i]), i)):
                if budget_left <= 0:
                    break
                t_n, d_n = left[i]
                tt, dd = min(chunk, t_n), min(chunk, d_n)
                if max(tt, dd) > budget_left:
                    cap = int(budget_left)
                    tt, dd = min(tt, cap), min(dd, cap)
                cost = max(tt, dd)
                if cost <= 0:
                    continue
                wave.append((i, tt, dd))
                left[i] = [t_n - tt, d_n - dd]
                budget_left -= cost
                consumed += cost
                if left[i] == [0, 0]:
                    completing.append(i)
                    del left[i]
            if not wave:
                break
            waves.append(wave)
        return waves, consumed, completing

    def _drive_prefill_chunks(self, budget: float = math.inf) -> int:
        """Stream chunk waves into every PREFILLING slot, consuming at most
        ``budget`` metered tokens.  Each wave is ONE batched target dispatch
        over all slots (ragged ``chunk_lens``; 0 freezes a slot) plus, with
        a draft pairing, ONE batched draft dispatch.  Slots whose prompt
        completes on both sides get their first token from the wave that
        completed the target stream, fetched in ONE batched transfer at the
        end.  Returns tokens consumed (0 on a monolithic engine)."""
        self.last_prefill_slot_tokens = {}
        if not self.prefill_chunk:
            return 0
        waves, consumed, _ = self._plan_prefill_waves(budget)
        if not waves:
            return 0
        for wave in waves:
            for i, tt, dd in wave:
                self.last_prefill_slot_tokens[i] = (
                    self.last_prefill_slot_tokens.get(i, 0) + max(tt, dd)
                )
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers every admission
        chunk = self.prefill_chunk
        completed: list[int] = []
        for wave in waves:
            t_lens = np.zeros((self.max_slots,), np.int32)
            d_lens = np.zeros((self.max_slots,), np.int32)
            t_toks = np.zeros((self.max_slots, chunk), np.int32)
            d_toks = np.zeros((self.max_slots, chunk), np.int32)
            t_done: list[int] = []
            for i, tt, dd in wave:
                if tt:
                    buf = self._prefill_left[i]
                    t_toks[i, :tt] = buf[:tt]
                    t_lens[i] = tt
                    self._prefill_left[i] = buf[tt:]
                    self._slot_idx[i] += tt
                    if len(self._prefill_left[i]) == 0:
                        t_done.append(i)
                if dd:
                    dbuf = self._draft_prefill_left[i]
                    d_toks[i, :dd] = dbuf[:dd]
                    d_lens[i] = dd
                    self._draft_prefill_left[i] = dbuf[dd:]
            if t_lens.any():
                self._record_prefill_program("target", "chunk", chunk)
                next_toks, index = self._chunk_wave("target", t_toks, t_lens)
                self.cache = dict(self.cache, index=index)
                for i in t_done:
                    # hold the completing wave's device argmax; the slot may
                    # still owe draft chunks before it finishes
                    self._prefill_tok[i] = next_toks
            if d_lens.any():
                self._record_prefill_program("draft", "chunk", chunk)
                _, index = self._chunk_wave("draft", d_toks, d_lens)
                self.draft_cache = dict(self.draft_cache, index=index)
            self.steps_executed += 1
            for i, _, _ in wave:
                t, d = self._prefill_left[i], self._draft_prefill_left[i]
                if len(t) == 0 and (d is None or len(d) == 0):
                    completed.append(i)
        if completed:
            toks = torch.stack(
                [self._prefill_tok[i][i] for i in completed]
            ).cpu().tolist()
            self.d2h_transfers += 1  # one batched fetch covers every finish
            now = self.clock()
            for i, tok in zip(completed, toks):
                self._finish_prefill(i, int(tok), now)
        self.prefill_metered_tokens += consumed
        return consumed

    def _chunk_wave(self, model: str, toks: np.ndarray, lens: np.ndarray) -> tuple:
        """One wave of ``model``'s chunked-prefill program (its one graph on
        CUDA, captured with every chunk length 0: a frozen slot writes
        nothing live).  Returns ``(next_tokens [B], index [B])``."""
        target = model == "target"
        cfg, params = (self.cfg, self.params) if target else (self.draft_cfg, self.draft_params)
        cache = self.cache if target else self.draft_cache
        kw = {} if target else {"need_logits": False}

        def fn(inp):
            view = dict(self.cache if target else self.draft_cache, index=inp["index"])
            if "block_tables" in inp:
                view["block_tables"] = inp["block_tables"]
            next_toks, new = T.prefill_chunks_into_slots(
                cfg, params, inp["tokens"], inp["lens"], view,
                compute_dtype=self.compute_dtype, attn_impl=self.attn_impl, **kw)
            return next_toks, new["index"]

        inputs = self._cache_inputs(cache, tokens=torch.tensor(toks, device=self.device),
                                    lens=torch.tensor(lens, device=self.device))
        frozen = dict(inputs, tokens=torch.zeros_like(inputs["tokens"]),
                      lens=torch.zeros_like(inputs["lens"]))
        return self._program(("chunk", model), fn, inputs, capture=frozen)

    def _finish_prefill(self, i: int, tok: int, now: float) -> None:
        """PREFILLING -> RUNNING: deliver the first generated token, stamp
        TTFT, and (paged) insert the prompt's full pages into the radix
        tree."""
        req = self.slots[i]
        self._prefill_left[i] = None
        self._draft_prefill_left[i] = None
        self._prefill_tok[i] = None
        req.generated.append(tok)
        self.generated_tokens_total += 1
        if req.first_token_time is None:
            req.first_token_time = now
        self.tokens[i] = tok
        if self.paged:
            prompt = np.asarray(req.prompt, np.int32)
            self.prefix_cache.insert(
                prompt, self._slot_pages[i][: len(prompt) // self.kv_page_size]
            )

    # ------------------------------------------------------------------
    @property
    def core(self):
        """The engine's lazily-built ``EngineCore`` (``serving/core.py``)."""
        if self._core is None:
            from repro_torch.serving.core import EngineCore

            self._core = EngineCore(self)
        return self._core

    def _admit_request(self, req: Request) -> bool:
        """Admit ``req`` into a free slot.  A chunked engine only reserves the
        slot, which stays PREFILLING until ``_drive_prefill_chunks`` streams
        its last chunk; a monolithic engine prefills the whole prompt here
        (one dispatch per model) and delivers the first token.  False when no
        slot is free or (paged) the pool cannot cover the worst-case page
        need even after evicting unreferenced cached prefixes."""
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        if len(req.prompt) > self.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds engine "
                f"max_seq={self.max_seq}; refusing to truncate silently"
            )
        if self.prefill_chunk:
            return self._begin_chunked_admit(slot, req)
        if self.paged:
            tok = self._paged_admit(slot, req)
            if tok is None:
                return False
        else:
            tok = self._dense_admit(slot, req)
        tok = int(tok)
        req.generated.append(tok)
        self.d2h_transfers += 1
        self.generated_tokens_total += 1
        if req.first_token_time is None:
            req.first_token_time = self.clock()
        self.tokens[slot] = tok
        self.slots[slot] = req
        self.steps_executed += 1
        return True

    # ------------------------------------------------------------------
    # Monolithic prefill: power-of-two buckets, one dispatch per admission
    # ------------------------------------------------------------------
    def _bucket_len(self, n: int, page_aligned: Optional[bool] = None) -> int:
        """Power-of-two bucket for a prompt of ``n`` tokens, from
        ``MIN_PREFILL_BUCKET`` (a page when paged).  Page-aligned buckets (the paged default) cap
        at ``max_seq`` rounded UP to a page multiple (positions past
        ``max_seq`` are pad, scattered into the sentinel); dense consumers
        (the dense layout, and a draft's dense cache on a paged engine) pass
        ``page_aligned=False`` and cap at ``max_seq``."""
        if page_aligned is None:
            page_aligned = self.paged
        b = self.min_prefill_bucket
        while b < n:
            b *= 2
        if page_aligned:
            return min(b, self.pages_per_slot * self.kv_page_size)
        return min(b, self.max_seq)

    def _bucket_buf(
        self, tokens: np.ndarray, page_aligned: Optional[bool] = None,
        model: str = "target", impl: str = "bucket",
    ) -> torch.Tensor:
        """``tokens`` zero-padded to their bucket: a [1, S_bucket] int32
        tensor on the device.  Records the prefill program of ``model`` and
        ``impl`` at that width, as the reference's ``_bucket_buf``."""
        sb = self._bucket_len(len(tokens), page_aligned)
        self._record_prefill_program(model, impl, sb)
        buf = np.zeros((1, sb), np.int32)
        buf[0, : len(tokens)] = tokens
        return torch.tensor(buf, device=self.device)

    def _record_prefill_program(self, model: str, impl: str, width: int) -> None:
        self._prefill_programs.setdefault((model, impl), set()).add(width)

    @property
    def prefill_compile_count(self) -> int:
        """Distinct prefill programs across models and impls, one per
        (model, impl, width) triple, as the reference counts its compiles:
        chunked prefill pins it to one fixed-width program per model, the
        bucket family grows with the prompt lengths.  On CUDA with graphs
        each is one captured graph (``prefill_graph_count``)."""
        return sum(len(v) for v in self._prefill_programs.values())

    def prefill_compile_counts(self) -> dict[str, int]:
        """``prefill_compile_count`` by ``"model/impl"`` (target / draft x
        bucket / suffix / chunk)."""
        return {f"{model}/{impl}": len(widths)
                for (model, impl), widths in sorted(self._prefill_programs.items())}

    @property
    def prefill_graph_count(self) -> int:
        """Captured prefill graphs (chunk, bucket and suffix programs)."""
        return sum(key[0] in ("chunk", "bucket", "suffix") for key in self._graphs)

    def _int_arg(self, n: int) -> torch.Tensor:
        """A traced scalar argument: a 0-d int32 device tensor."""
        return torch.tensor(n, dtype=torch.int32, device=self.device)

    def _bucket_prefill(self, model: str, buf: torch.Tensor, n: int, slot: int) -> torch.Tensor:
        """``model``'s bucket prefill of ``buf`` (``n`` real tokens) into
        ``slot``: the paged target's page scatter or a dense row (the draft:
        its dense cache).  One graph per model and bucket width on CUDA,
        captured with the admission's own inputs (the replay writes the same
        rows again).  Returns the first token."""
        target = model == "target"
        cfg, params = (self.cfg, self.params) if target else (self.draft_cfg, self.draft_params)
        paged = target and self.paged

        def fn(inp):
            x = self._embed_or_pass(params, inp["tokens"])
            view = dict(self.cache if target else self.draft_cache, index=inp["index"])
            if paged:
                view["block_tables"] = inp["block_tables"]
                tok, new = T.prefill_into_slot_paged(
                    cfg, params, x, inp["length"], inp["slot"], view, impl=self.attn_impl,
                    compute_dtype=self.compute_dtype)
            else:
                tok, new = T.prefill_into_slot(
                    cfg, params, x, inp["length"], inp["slot"], view, max_seq=self.max_seq,
                    impl=self.attn_impl, compute_dtype=self.compute_dtype)
            return tok, new["index"]

        cache = self.cache if target else self.draft_cache
        inputs = self._cache_inputs(cache, tokens=buf, length=self._int_arg(n),
                                    slot=self._int_arg(slot))
        tok, index = self._program(("bucket", model, buf.shape[1]), fn, inputs)
        if target:
            self.cache = dict(self.cache, index=index)
        else:
            self.draft_cache = dict(self.draft_cache, index=index)
        return tok

    def _embed_or_pass(self, params: Any, buf: torch.Tensor) -> torch.Tensor:
        """A monolithic prefill's inputs: an ``embed_inputs`` config's stub
        frontend embeds the bucket's tokens through ``params``' table (the
        reference's ``_embed_or_pass``); any other takes the tokens."""
        if self.cfg.embed_inputs:
            return params["embed"][buf.long()].to(self.compute_dtype)
        return buf

    def _draft_prefill(self, slot: int, prompt: np.ndarray) -> None:
        """The draft's dense cache tracks the whole prompt (no prefix pool);
        its first-token output is never fetched.  Its bucket caps at
        ``max_seq``."""
        buf = self._bucket_buf(prompt, page_aligned=False, model="draft")
        self._bucket_prefill("draft", buf, len(prompt), slot)

    def _paged_admit(self, slot: int, req: Request) -> Optional[torch.Tensor]:
        """Paged MONOLITHIC admission: reserve pages, then prefill in one
        dispatch -- the whole prompt on a radix miss, only the suffix on a
        hit (``prefill_suffix_into_slot``).  Returns the first token (on the
        device), or None on capacity."""
        shared = self._paged_reserve(slot, req)
        if shared is None:
            return None
        self._sync_block_tables()  # the prefill dispatch reads the tables
        n = len(req.prompt)
        prompt = np.asarray(req.prompt, np.int32)
        self._slot_idx[slot] = n
        if shared:
            suffix = prompt[shared:]
            tok = self._suffix_prefill(self._bucket_buf(suffix, impl="suffix"),
                                       len(suffix), shared, slot)
            self.prefill_skipped_tokens += shared
        else:
            tok = self._bucket_prefill("target", self._bucket_buf(prompt), n, slot)
        self.prefill_prompt_tokens += n
        self.prefill_metered_tokens += n if self.spec_enabled else n - shared
        # cache the prompt's full pages for future admissions (the tree takes
        # its own reference; they outlive this slot)
        self.prefix_cache.insert(prompt, self._slot_pages[slot][: n // self.kv_page_size])
        if self.spec_enabled:
            self._draft_prefill(slot, prompt)
        return tok

    def _suffix_prefill(self, buf: torch.Tensor, suffix_len: int, shared: int,
                        slot: int) -> torch.Tensor:
        """The radix-hit suffix prefill (``prefill_suffix_into_slot``): one
        graph per bucket width on CUDA, captured with the admission's own
        inputs.  Returns the first token."""
        def fn(inp):
            view = dict(self.cache, index=inp["index"], block_tables=inp["block_tables"])
            tok, new = T.prefill_suffix_into_slot(
                self.cfg, self.params, inp["tokens"], inp["suffix_len"], inp["shared_len"],
                inp["slot"], view, compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
            return tok, new["index"]

        inputs = self._cache_inputs(self.cache, tokens=buf, suffix_len=self._int_arg(suffix_len),
                                    shared_len=self._int_arg(shared), slot=self._int_arg(slot))
        tok, index = self._program(("suffix", "target", buf.shape[1]), fn, inputs)
        self.cache = dict(self.cache, index=index)
        return tok

    def _dense_admit(self, slot: int, req: Request) -> torch.Tensor:
        """Dense-layout MONOLITHIC admission: one bucket prefill straight into
        the slot's rows (Mamba1: its state).  Returns the first token (on the
        device)."""
        prompt = np.asarray(req.prompt, np.int32)
        n = len(prompt)
        tok = self._bucket_prefill("target", self._bucket_buf(prompt), n, slot)
        self.prefill_prompt_tokens += n
        self.prefill_metered_tokens += n
        if self.spec_enabled:
            self._draft_prefill(slot, prompt)
        return tok

    # ------------------------------------------------------------------
    # Fault injection and containment
    # ------------------------------------------------------------------
    def _poisonable(self, i: int) -> bool:
        """Slot ``i`` is decoding and its last written position lies past
        the prompt's full pages, which the radix tree may share (only a
        private page can be scrubbed at quarantine)."""
        r = self.slots[i]
        if r is None or self.slot_prefilling(i) or not r.generated:
            return False
        if not self.paged:
            return True
        ps = self.kv_page_size
        return (self._slot_idx[i] - 1) // ps >= len(r.prompt) // ps

    def _maybe_inject_nan(self) -> None:
        """Consult ``engine/nan_logits`` before a fused dispatch; on a fire,
        poison layer 0's K of one decodable slot at its last written
        position, so its next attention read gives NaN logits for that slot
        alone.  Only a slot whose last write lies past its prompt's full
        pages is a victim (``_poisonable``), so a radix-cached prefix is
        never poisoned and the point is consulted only when one exists: the
        reference states that rule but breaks it for a slot whose prompt
        fills whole pages and has just finished its prefill.  Written in
        place: a captured decode graph reads the pool where it lives."""
        inj = self.fault_injector
        if inj is None:
            return
        if "k" not in self.cache["layers"]:
            # the recurrent families: no KV position to poison (the hybrid's
            # shared K/V included, as the reference's ``"k" in layers`` test)
            inj.should_fire("engine/nan_logits")
            return
        cands = [i for i in range(self.max_slots) if self._poisonable(i)]
        if not cands or not inj.should_fire("engine/nan_logits"):
            return
        slot = cands[inj.choice("engine/nan_logits", len(cands))]
        k = self.cache["layers"]["k"]
        if self.paged:
            pos = self._slot_idx[slot] - 1
            page = self._slot_pages[slot][pos // self.kv_page_size]
            k[0, page, pos % self.kv_page_size] = float("nan")
        else:
            pos = int(self.cache["index"][slot]) - 1
            k[0, slot, pos] = float("nan")

    def _scrub_slot_kv(self, i: int) -> None:
        """Zero, in place, the KV a quarantined slot wrote before its pages
        or rows are released: a masked position still adds ``0 * NaN`` to an
        attention sum, so a freed page must hold finite data.  Pages the
        radix tree shares are left alone (the poison never lands there)."""
        layers = self.cache["layers"]
        if "k" not in layers:
            return
        if self.paged:
            private = [p for p in self._slot_pages[i] if self.pool.refcount[p] == 1]
            if private:
                idx = torch.tensor(private, device=self.device)
                layers["k"].index_fill_(1, idx, 0)
                layers["v"].index_fill_(1, idx, 0)
        else:
            layers["k"][:, i] = 0
            layers["v"][:, i] = 0

    def _quarantine_slot(self, i: int) -> Request:
        """Containment of a slot whose logits came back non-finite: count it,
        scrub its KV, evict it and hand the request to the core's fault path
        (bounded-retry requeue).  The poisoned dispatch's tokens are never
        absorbed, so the retry's stream equals a fault-free run's."""
        self.obs.metrics.counter("fault/nan_quarantines").inc()
        self._scrub_slot_kv(i)
        req = self.evict_slot(i, sync=False)
        if self._core is not None:
            self._core._on_slot_fault(i, req)
        return req

    # ------------------------------------------------------------------
    @property
    def graphs(self) -> bool:
        """Whether the serving programs replay CUDA graphs: on CUDA, with the
        kernels (``decode_impl`` not "torch")."""
        return self.device.type == "cuda" and self.attn_impl != "torch"

    @property
    def _decode_graphs(self) -> dict:
        """The decode loop's graphs by ``k``."""
        return {key[1]: g for key, g in self._graphs.items() if key[0] == "decode"}

    def graph_pool_bytes(self) -> int:
        """Device bytes of the pool the engine's graphs share (0 before the
        first capture)."""
        return 0 if self._graph_pool is None else pool_bytes(self._graph_pool)

    def _cache_ptrs(self) -> tuple:
        """Addresses of every cache tensor a program reads in place (the
        target's and the draft's, nested leaves included)."""
        leaves = tree_leaves(self.cache["layers"])
        if self.draft_cache is not None:
            leaves += tree_leaves(self.draft_cache["layers"])
        return tuple(t.data_ptr() for t in leaves)

    def _cache_inputs(self, cache, **inputs) -> dict:
        """A program's varying inputs: ``inputs`` plus ``cache``'s index and,
        on the paged layout, its block tables."""
        inputs["index"] = cache["index"]
        if "block_tables" in cache:
            inputs["block_tables"] = cache["block_tables"]
        return inputs

    def _program(self, key: tuple, fn, inputs: dict, capture: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, warm=None) -> tuple:
        """``fn(inputs)``: eagerly, or (``graphs``) a replay of ``key``'s
        graph, captured first if needed (with ``capture``'s inputs, default
        ``inputs``; ``warm`` as ``_graph``), whose outputs are cloned (a
        later replay on the shared pool may reuse their memory).  A capture
        or replay that fails raises."""
        if not self.graphs:
            return fn(inputs)
        graph = self._graph(key, fn, capture or inputs, generator, warm)
        return tuple(t.clone() for t in graph.replay(inputs))

    def _drop_moved_graphs(self) -> None:
        """Drop every graph if a cache tensor moved since they were
        captured (they read and write the old addresses)."""
        ptrs = self._cache_ptrs()
        if ptrs != self._graph_ptrs:
            self._graphs = {}
            self._graph_ptrs = ptrs

    def _graph(self, key: tuple, fn, inputs: dict,
               generator: Optional[torch.Generator] = None, warm=None) -> GraphProgram:
        """``key``'s graph, captured over ``inputs`` if it has none yet or a
        cache tensor moved since (then every graph is dropped).  ``warm``:
        ``(warm key, function)`` of the warm-up before a capture, run once
        a warm key and engine (default ``(key, fn)``): the decode loop of
        any ``k`` warms as its one step, the spec loop as its one round."""
        self._drop_moved_graphs()
        graph = self._graphs.get(key)
        if graph is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            warm_key, warm_fn = warm or (key, fn)
            if warm_key in self._warmed:
                warm_fn = None
            self._warmed.add(warm_key)
            graph = self._graphs[key] = GraphProgram(
                fn, inputs, pool=self._graph_pool, side=self._graph_stream, warm=warm_fn,
                generator=generator)
        return graph

    @contextlib.contextmanager
    def _states_kept(self):
        """Put the target's recurrent state back after the block: a decode
        capture's frozen slots still step their state (as an eager loop's
        frozen slots do), and a live slot's must not move."""
        live = T.chunk_recurrent_states(self.cfg, self.cache["layers"])
        saved = [] if live is None else [t.clone() for t in tree_leaves(live)]
        yield
        for dst, src in zip(tree_leaves(live) if saved else [], saved):
            dst.copy_(src)

    def _remaining(self) -> np.ndarray:
        """[B] token budgets of the RUNNING slots (0 elsewhere)."""
        remaining = np.zeros((self.max_slots,), np.int32)
        for i, r in enumerate(self.slots):
            if r is not None and not self.slot_prefilling(i):
                remaining[i] = max(r.max_new_tokens - len(r.generated), 0)
        return remaining

    def _drive_decode_loop(self, k: int) -> list[Request]:
        """Run ``k`` greedy decode microsteps over every RUNNING slot;
        returns the requests that finished.  ONE device -> host transfer,
        whatever ``k``.  Finished and PREFILLING slots freeze on the device
        (zero budget), so the host never intervenes between microsteps."""
        if self.num_active == 0 or k <= 0:
            return []
        if self.num_active == self.num_prefilling:
            return []  # every slot is mid-prefill: nothing to decode
        if self.paged:
            self._top_up_pages(k)
            if self.num_active == 0:
                return []  # every slot fell to an allocator fault
        self._maybe_inject_nan()
        inputs = self._cache_inputs(
            self.cache, tokens=self.tokens,
            remaining=torch.tensor(self._remaining(), device=self.device))
        if self.graphs:
            self._drop_moved_graphs()
            if ("decode", k) not in self._graphs:
                # every size at once, from frozen inputs (zero budgets): a
                # capture grows the allocator's pools, which should not land
                # between later (training) steps
                frozen = dict(inputs, remaining=torch.zeros_like(inputs["remaining"]))
                with self._states_kept():
                    for n in sorted({*DECODE_K_BUCKETS, k}):
                        self._graph(("decode", n), self._decode_fn(n), frozen,
                                    warm=(("decode",), self._decode_fn(1)))
        tokens, index, rem, toks_seq, steps, bad = self._program(
            ("decode", k), self._decode_fn(k), inputs)
        self.tokens, self.cache = tokens, dict(self.cache, index=index)
        b = self.max_slots
        fetched = torch.cat([
            toks_seq.reshape(-1), steps, rem, index, bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # the single fused fetch above
        toks_np = fetched[: k * b].reshape(k, b)
        steps_np, rem_np, idx_np, bad_np = fetched[k * b:].reshape(4, b)
        self.steps_executed += k
        now = self.clock()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
                continue
            if bad_np[i]:
                # the loop's tokens of this slot are garbage (the screen
                # cannot say which microstep went bad): drop them all
                self._quarantine_slot(i)
                continue
            n = int(steps_np[i])
            req.generated.extend(int(t) for t in toks_np[:n, i])
            self.generated_tokens_total += n
            self._slot_idx[i] = int(idx_np[i])
            if rem_np[i] == 0 or idx_np[i] >= self.max_seq - 1:
                finished.append(self._retire_slot(i, now))
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers every retirement
        return finished

    def _decode_fn(self, k: int):
        """The decode loop of ``k`` microsteps over the program inputs."""
        def fn(inp):
            view = dict(self.cache, index=inp["index"])
            if "block_tables" in inp:
                view["block_tables"] = inp["block_tables"]
            tokens, new, rem, toks_seq, steps, bad = T.decode_loop(
                self.cfg, self.params, inp["tokens"], view, inp["remaining"], k=k,
                max_seq=self.max_seq, compute_dtype=self.compute_dtype,
                attn_impl=self.attn_impl)
            return tokens, new["index"], rem, toks_seq, steps, bad
        return fn

    def decode_microstep(self) -> list[Request]:
        """One greedy decode step over every slot; returns the requests that
        finished.  The reference's single-step path: ``T.decode_step`` and
        its argmax (a graph of its own on CUDA, key ``("step",)``), with the
        token vector and the finish-check indices fetched in ONE device ->
        host transfer.  The fused ``_drive_decode_loop`` is the fast path."""
        if self.num_active == 0 or self.num_active == self.num_prefilling:
            return []
        if self.paged:
            self._top_up_pages(1)
        inputs = self._cache_inputs(self.cache, tokens=self.tokens)
        if self.graphs:
            self._drop_moved_graphs()
            if ("step",) not in self._graphs:
                # captured from the live inputs: the warm-up writes the K/V
                # rows the replay then writes again, and a recurrent state it
                # stepped is put back
                with self._states_kept():
                    self._graph(("step",), self._step_fn, inputs)
        self.tokens, index = self._program(("step",), self._step_fn, inputs)
        self.cache = dict(self.cache, index=index)
        self.steps_executed += 1
        if self.num_prefilling:
            # the step advanced EVERY slot's index: restore the PREFILLING
            # slots' prefill progress in one batched write (their stale K/V
            # write at the old index is overwritten by the next chunk)
            slots, values = [], []
            for i in range(self.max_slots):
                if self.slot_prefilling(i):
                    left = self._prefill_left[i]
                    slots.append(i)
                    values.append(len(self.slots[i].prompt) - (
                        len(left) if left is not None else 0))
            self.cache["index"][torch.tensor(slots, device=self.device)] = torch.tensor(
                values, dtype=torch.int32, device=self.device)
        b = self.max_slots
        fetched = torch.cat([self.tokens, self.cache["index"]]).cpu().numpy()
        self.d2h_transfers += 1  # tokens + finish-check indices, batched
        host_tokens, idx_np = fetched[:b], fetched[b:]
        now = self.clock()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
                continue
            req.generated.append(int(host_tokens[i]))
            self.generated_tokens_total += 1
            self._slot_idx[i] = int(idx_np[i])
            if len(req.generated) >= req.max_new_tokens or idx_np[i] >= self.max_seq - 1:
                finished.append(self._retire_slot(i, now))
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers every retirement
        return finished

    def _step_fn(self, inp):
        """``decode_microstep``'s program: one ``T.decode_step`` over the
        program inputs and its argmax; returns ``(tokens, index)``."""
        view = dict(self.cache, index=inp["index"])
        if "block_tables" in inp:
            view["block_tables"] = inp["block_tables"]
        logits, new = T.decode_step(self.cfg, self.params, inp["tokens"], view,
                                    compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
        return torch.argmax(logits, dim=-1).to(torch.int32), new["index"]

    # ------------------------------------------------------------------
    # Speculative decoding
    # ------------------------------------------------------------------
    def _drive_spec_loop(self, k: int, gamma: int) -> list[Request]:
        """Run ``k`` fused speculative rounds (draft-propose + chunk-verify);
        returns the requests that finished.  ONE device -> host transfer.
        Each round emits up to ``gamma + 1`` verified tokens per slot (greedy
        mode: exactly the plain greedy stream).  A slot needs room for a
        whole chunk, so it retires once ``index + gamma >= max_seq``."""
        if not self.spec_enabled:
            raise RuntimeError("engine built without a draft pairing")
        if self.num_active == 0 or k <= 0:
            return []
        if self.num_active == self.num_prefilling:
            return []  # every slot is mid-prefill: nothing to verify
        if self.paged:
            # worst case every round accepts the whole chunk
            self._top_up_pages(k * (gamma + 1))
            if self.num_active == 0:
                return []  # every slot fell to an allocator fault
        self._maybe_inject_nan()
        greedy = self.spec_cfg.mode == "greedy"
        inputs = self._cache_inputs(
            self.cache, tokens=self.tokens, draft_index=self.draft_cache["index"],
            remaining=torch.tensor(self._remaining(), device=self.device))
        # captured with zero budgets: every slot frozen (a recurrent state
        # is put back by the round itself)
        frozen = dict(inputs, remaining=torch.zeros_like(inputs["remaining"]))
        (
            self.tokens, index, draft_index, rem,
            out_toks, n_out, accepted, proposed, bad,
        ) = self._program(("spec", k, gamma), self._spec_fn(k, gamma), inputs, capture=frozen,
                          generator=None if greedy else self._spec_gen,
                          warm=(("spec", gamma), self._spec_fn(1, gamma)))
        self.cache = dict(self.cache, index=index)
        self.draft_cache = dict(self.draft_cache, index=draft_index)
        b, t = self.max_slots, gamma + 1
        fetched = torch.cat([
            out_toks.reshape(-1), n_out.reshape(-1), accepted.reshape(-1),
            proposed.reshape(-1), rem, self.cache["index"], bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # the single fused fetch above
        toks_np = fetched[: k * b * t].reshape(k, b, t)
        n_np, acc_np, prop_np = fetched[k * b * t: k * b * (t + 3)].reshape(3, k, b)
        rem_np, idx_np, bad_np = fetched[k * b * (t + 3):].reshape(3, b)
        self.steps_executed += k
        self.spec_rounds += k
        now = self.clock()
        finished = []
        self._last_spec_slot_stats = {}
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
                continue
            if bad_np[i]:
                # every round of this slot is suspect: drop the loop's output
                # (and its acceptance counts) and quarantine
                self._quarantine_slot(i)
                continue
            for j in range(k):
                n = int(n_np[j, i])
                req.generated.extend(int(x) for x in toks_np[j, i, :n])
                self.generated_tokens_total += n
            slot_acc, slot_prop = int(acc_np[:, i].sum()), int(prop_np[:, i].sum())
            self._last_spec_slot_stats[i] = (slot_acc, slot_prop)
            self.spec_accepted += slot_acc
            self.spec_drafted += slot_prop
            self._slot_idx[i] = int(idx_np[i])
            if rem_np[i] == 0 or idx_np[i] + gamma >= self.max_seq:
                finished.append(self._retire_slot(i, now))
            elif self.paged:
                # rollback freed the positions past the accepted prefix
                self._trim_slot_pages(i)
        if self.num_prefilling:
            self._restore_draft_prefill_indices()
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers trims + retires
        return finished

    def _spec_fn(self, k: int, gamma: int):
        """The fused spec loop of ``k`` rounds over the program inputs."""
        def fn(inp):
            view = dict(self.cache, index=inp["index"])
            if "block_tables" in inp:
                view["block_tables"] = inp["block_tables"]
            dview = dict(self.draft_cache, index=inp["draft_index"])
            tokens, new, dnew, *rest = spec_decode_loop(
                self.cfg, self.draft_cfg, self.params, self.draft_params,
                inp["tokens"], view, dview, inp["remaining"], k=k, gamma=gamma,
                mode=self.spec_cfg.mode, max_seq=self.max_seq,
                sim_accept_p=self.spec_cfg.sim_accept_p, gen=self._spec_gen,
                compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
            return (tokens, new["index"], dnew["index"], *rest)
        return fn

    def _restore_draft_prefill_indices(self) -> None:
        """Re-pin the draft index of PREFILLING slots to their draft
        progress: the spec loop keeps draft and target indices equal for
        every slot, frozen ones included, which is wrong exactly while a
        slot's two prompt streams sit at different offsets."""
        for i in range(self.max_slots):
            if self.slot_prefilling(i):
                d = self._draft_prefill_left[i]
                self.draft_cache["index"][i] = len(self.slots[i].prompt) - (
                    len(d) if d is not None else 0
                )

    def _note_proposer_round(
        self, name: str, rounds: int, accepted: int, proposed: int
    ) -> None:
        m = self.obs.metrics
        m.counter(f"spec/proposer/rounds/{name}").inc(rounds)
        m.counter(f"spec/proposer/proposed/{name}").inc(proposed)
        m.counter(f"spec/proposer/accepted/{name}").inc(accepted)
        ptot = m.counter(f"spec/proposer/proposed/{name}").value
        if ptot:
            m.gauge(f"spec/proposer/acceptance/{name}").set(
                m.counter(f"spec/proposer/accepted/{name}").value / ptot
            )

    def _drive_proposed_loop(
        self, k: int, gamma: int, proposer: Optional[str] = None
    ) -> list[Request]:
        """Run ``k`` routed speculative rounds; returns the requests that
        finished.  The draft model delegates to the fused
        ``_drive_spec_loop`` (k rounds, one transfer); a host proposer runs
        ``k`` tree-verify rounds at one dispatch and one transfer EACH (the
        host must see a round's tokens to propose the next tree).  A round
        where the proposer matches nothing falls back to one plain decode
        step."""
        if proposer is None:
            proposer = self.route_proposer(gamma)
        if proposer is None or proposer not in self._proposers:
            raise ValueError(f"no proposer routed (got {proposer!r})")
        prop = self._proposers[proposer]
        if prop.kind == "device":
            a0, p0, r0 = self.spec_accepted, self.spec_drafted, self.spec_rounds
            finished = self._drive_spec_loop(k, gamma)
            self._note_proposer_round(
                proposer, self.spec_rounds - r0,
                self.spec_accepted - a0, self.spec_drafted - p0,
            )
            for i, (acc, prp) in self._last_spec_slot_stats.items():
                if self.slots[i] is not None:  # retired slots were reset
                    self._router.observe(i, proposer, acc, prp)
            return finished
        width = max(1, self.spec_cfg.tree_width)
        mode = "simulated" if self.spec_cfg.mode == "simulated" else "greedy"
        finished: list[Request] = []
        for _ in range(k):
            if self.num_active == 0 or self.num_active == self.num_prefilling:
                break
            remaining = self._remaining()
            if not remaining.any():
                break
            hists = [
                [int(t) for t in r.prompt] + r.generated
                if r is not None and not self.slot_prefilling(i) else []
                for i, r in enumerate(self.slots)
            ]
            tree = prop.propose(ProposeContext(
                histories=hists, active=remaining > 0, gamma=gamma, width=width,
            ))
            if tree is None:
                # no slot matched: zero-acceptance evidence for the router
                # (nothing was drafted, so the counters stay clean)
                self.obs.metrics.counter("spec/proposer/no_match_fallbacks").inc()
                for i in np.flatnonzero(remaining > 0):
                    self._router.observe(int(i), proposer, 0, gamma)
                finished.extend(self._drive_decode_loop(1))
                continue
            finished.extend(
                self._tree_round(prop, proposer, tree, remaining, gamma, mode)
            )
        return finished

    def _tree_round_fn(self, parents: tuple, mode: str):
        """The tree-verify round of one topology (the reference's name and
        key): a program over the inputs ``tokens``, ``tail``, ``remaining``
        and the cache's index (and block tables), returning ``(tokens,
        index, remaining, out, n_out, accepted, proposed, bad)``.  The
        topology's device constants are built here, once, outside the
        program.  Topologies come from the gamma and width buckets, so the
        programs stay as bounded as the fused loops'."""
        fn = self._tree_round_cache.get((parents, mode))
        if fn is None:
            topo = spec_tree.tree_topology(parents, self.max_slots, self.device)

            def fn(inp):
                view = dict(self.cache, index=inp["index"])
                if "block_tables" in inp:
                    view["block_tables"] = inp["block_tables"]
                tokens, new, *rest = spec_tree.tree_verify_round(
                    self.cfg, self.params, inp["tokens"], view, inp["tail"], inp["remaining"],
                    parents=parents, mode=mode, max_seq=self.max_seq,
                    sim_accept_p=self.spec_cfg.sim_accept_p, gen=self._spec_gen,
                    compute_dtype=self.compute_dtype, attn_impl=self.attn_impl, topo=topo)
                return (tokens, new["index"], *rest)

            self._tree_round_cache[(parents, mode)] = fn
        return fn

    def _tree_round(self, prop, name: str, tree, remaining: np.ndarray,
                    gamma: int, mode: str) -> list[Request]:
        """One tree-verify round over a host proposer's candidate tree: a
        replay of its topology's graph on CUDA (``_tree_round_fn``), one
        fetch."""
        n_nodes = len(tree.parents)
        if self.paged:
            # worst case the round accepts a whole root-to-leaf path;
            # node-index K/V slots need n_nodes positions regardless
            self._top_up_pages(n_nodes)
            if self.num_active == 0:
                return []  # every slot fell to an allocator fault
        self._maybe_inject_nan()
        inputs = self._cache_inputs(
            self.cache, tokens=self.tokens, tail=torch.tensor(tree.tail, device=self.device),
            remaining=torch.tensor(remaining, device=self.device))
        # captured with zero budgets: every slot frozen (its compaction the
        # identity, its K/V rows written again by the replay)
        frozen = dict(inputs, remaining=torch.zeros_like(inputs["remaining"]))
        (
            self.tokens, index, rem, out, n_out, accepted, proposed, bad,
        ) = self._program(("tree", tree.parents, mode), self._tree_round_fn(tree.parents, mode),
                          inputs, capture=frozen,
                          generator=None if mode == "greedy" else self._spec_gen)
        self.cache = dict(self.cache, index=index)
        b, w = out.shape
        fetched = torch.cat([
            out.reshape(-1), n_out, accepted, proposed, rem, self.cache["index"],
            bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # one per round: proposals need the history
        toks_np = fetched[: b * w].reshape(b, w)
        n_np, acc_np, prop_np, rem_np, idx_np, bad_np = fetched[b * w:].reshape(6, b)
        self.steps_executed += 1
        self.spec_rounds += 1
        self.obs.metrics.gauge("spec/proposer/tree_nodes").set(n_nodes)
        round_acc = round_prop = 0
        now = self.clock()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
                continue
            if bad_np[i]:
                self._quarantine_slot(i)
                continue
            n = int(n_np[i])
            req.generated.extend(int(x) for x in toks_np[i, :n])
            self.generated_tokens_total += n
            self._slot_idx[i] = int(idx_np[i])
            if tree.matched[i]:
                acc, prp = int(acc_np[i]), int(prop_np[i])
                round_acc += acc
                round_prop += prp
                self._router.observe(i, name, acc, prp)
                prop.observe(i, acc, prp)
            elif remaining[i] > 0:
                # the proposer declined this slot while serving others: zero
                # evidence for routing, but nothing drafted for the counters
                self._router.observe(i, name, 0, gamma)
            if rem_np[i] == 0 or idx_np[i] + (n_nodes - 1) >= self.max_seq:
                finished.append(self._retire_slot(i, now))
            elif self.paged:
                # rejected siblings past the accepted path: release the pages
                # the worst-case top-up provisioned beyond it
                self._trim_slot_pages(i)
        self.spec_accepted += round_acc
        self.spec_drafted += round_prop
        self._note_proposer_round(name, 1, round_acc, round_prop)
        if self._bt_dirty:
            self._sync_block_tables()
        return finished

    # ------------------------------------------------------------------
    def kv_cache_bytes(self) -> int:
        """Device bytes of the cache: the KV pools and block tables, or the
        dense rows (Mamba1: the conv and SSM state; the hybrid: its Mamba2
        state and the shared block's K/V rows)."""
        tensors = tree_leaves(self.cache["layers"])
        if self.paged:
            tensors.append(self.cache["block_tables"])
        return sum(t.numel() * t.element_size() for t in tensors)


def _to_device(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return params.to(device)

"""Continuous-batching inference engine on the paged, chunked, greedy path,
with speculative decoding.

Counterpart of ``repro.serving.engine.InferenceEngine`` in its default
layout: KV lives in a shared pool of 16-token physical pages addressed
through per-slot block tables (``serving/kv_pool.py``), admission reserves a
slot's worst-case pages and streams the prompt as fixed 32-token chunks
through ONE batched prefill program per wave, a radix tree serves shared
page-aligned prefixes from cached pages, and decode runs ``k`` greedy
microsteps per dispatch with a single device -> host fetch at the end.

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

The device is ``cuda`` unless the caller passes ``device="cpu"``; without a
CUDA device and without an explicit ``device="cpu"`` the constructor raises.
On CUDA the attention cores launch the hand-written kernels, on the CPU their
plain PyTorch versions.  The KV pool, block tables, indices and token vector
are updated in place (the reference's jit donates them).

Not in this slice: the dense target layout and monolithic prefill, fault
injection and NaN quarantine (a non-finite verify or decode logit raises
``FloatingPointError``), and non-dense drafts.
"""
from __future__ import annotations

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
from repro_torch.serving.kv_pool import PageAllocError, PagePool, RadixCache
from repro_torch.spec import tree as spec_tree
from repro_torch.spec.loop import spec_decode_loop
from repro_torch.spec.proposers import (
    DraftModelProposer,
    NgramProposer,
    ProposeContext,
    ProposerRouter,
)

_req_counter = itertools.count()

#: Fused-loop sizes callers pick their k from (the reference bounds its
#: compiled programs with them; the schedule is kept identical).
DECODE_K_BUCKETS = (1, 2, 4, 8)

#: Physical page size (tokens) of the paged KV pool.
DEFAULT_KV_PAGE_SIZE = 16

#: Chunked-prefill width (tokens per slot per wave).
DEFAULT_PREFILL_CHUNK = 32


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
    ):
        if cfg.family != "dense":
            raise ValueError(f"the port serves the dense family, not {cfg.family!r}")
        # the counter views' cells live in ``self.obs.metrics``: build it first
        self.obs = Observability()
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
        self.prefill_chunk = DEFAULT_PREFILL_CHUNK
        self.kv_page_size = DEFAULT_KV_PAGE_SIZE
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

        self.pages_per_slot = -(-max_seq // self.kv_page_size)
        # dense-equivalent logical capacity plus the sentinel page
        num_pages = max_slots * self.pages_per_slot + 1
        self.pool = PagePool(num_pages, self.kv_page_size)
        self.prefix_cache = RadixCache(self.pool)
        self.cache = T.init_paged_cache(
            cfg, max_slots, num_pages, self.kv_page_size, self.pages_per_slot,
            compute_dtype, self.device,
        )
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._slot_reserved = [0] * max_slots
        self._slot_idx = [0] * max_slots
        self._slot_horizon = [0] * max_slots
        # host mirror of the device block tables: mutations land here and
        # ship as ONE whole-table host -> device copy
        self._bt_host = np.zeros((max_slots, self.pages_per_slot + 1), np.int32)
        self._bt_dirty = False

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
            if draft_cfg is None:
                raise ValueError("draft_params without draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            self.draft_params = T.cast_params(
                _to_device(draft_params, self.device), compute_dtype
            )
            self.draft_cache = T.init_cache(
                draft_cfg, max_slots, max_seq, compute_dtype, self.device
            )

        # --- pluggable proposers + routing -------------------------------
        #: ``spec_cfg.proposer``: "auto" registers the draft model and the
        #: n-gram lookup on a draft-paired engine (nothing on a plain one);
        #: "draft" / "ngram" pin one ("ngram" speculates without a draft
        #: model); "none" disables routing
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
            if pchoice == "ngram" or (pchoice == "auto" and self.spec_enabled):
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
        ``StaticSuffixProposer``) and rebuild the router over the new set."""
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
        total_pages, _ = self._page_need(req)
        return total_pages <= self.pool.num_pages - 1

    def can_admit(self, req: Request) -> bool:
        """Capacity probe: a free slot exists AND the pool can cover the
        request's worst-case page need, counting evictable cached prefixes
        but never the pages the request itself would share.  Non-mutating."""
        if not self.free_slots() or not self.request_fits(req):
            return False
        total_pages, _ = self._page_need(req)
        prompt = np.asarray(req.prompt, np.int32)
        shared = self._shared_prefix(prompt, record=False)
        evictable = self.prefix_cache.evictable_pages() - sum(
            1 for p in shared if self.pool.refcount[p] == 1
        )
        return total_pages - len(shared) <= self.pool.available + evictable

    def _sync_block_tables(self) -> None:
        # a copy: the device table must not alias the host mirror
        self.cache["block_tables"] = torch.tensor(self._bt_host, device=self.device)
        self._bt_dirty = False

    def _top_up_pages(self, steps: int) -> None:
        """Extend every active slot's block table to cover its next
        ``steps`` token writes, turning admission reservations into pages,
        so the decode loop never needs a host allocation."""
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            cover = min(self._slot_idx[i] + steps, self._slot_horizon[i])
            need = self.pool.pages_for(cover)
            cur = len(self._slot_pages[i])
            if need > cur:
                got = self.pool.alloc(need - cur, reserved=True)
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
        """Release slot ``i`` -- pages back to the pool, both cache indices
        reset -- WITHOUT finishing the request (the preempt/abort primitive; resume
        re-prefills ``prompt + generated``, mostly from radix-cached pages).
        ``sync=False`` defers the block-table upload to the caller."""
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
        self.pool.decref(self._slot_pages[i])
        self.pool.unreserve(self._slot_reserved[i])
        self._slot_pages[i] = []
        self._slot_reserved[i] = 0
        self._slot_idx[i] = 0
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
        """Admission bookkeeping: match the radix prefix, make room (evicting
        LRU cached prefixes if needed), allocate the prompt pages and reserve
        the decode horizon.  Returns the shared token count, or None on
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
        the prompt then streams in ``_drive_prefill_chunks`` waves."""
        res = self._paged_reserve(slot, req)
        if res is None:
            return False
        shared = res
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
        end.  Returns tokens consumed."""
        self.last_prefill_slot_tokens = {}
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
                next_toks, self.cache = T.prefill_chunks_into_slots(
                    self.cfg, self.params,
                    torch.tensor(t_toks, device=self.device),
                    torch.tensor(t_lens, device=self.device), self.cache,
                    compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
                )
                for i in t_done:
                    # hold the completing wave's device argmax; the slot may
                    # still owe draft chunks before it finishes
                    self._prefill_tok[i] = next_toks
            if d_lens.any():
                _, self.draft_cache = T.prefill_chunks_into_slots(
                    self.draft_cfg, self.draft_params,
                    torch.tensor(d_toks, device=self.device),
                    torch.tensor(d_lens, device=self.device), self.draft_cache,
                    compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
                    need_logits=False,
                )
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

    def _finish_prefill(self, i: int, tok: int, now: float) -> None:
        """PREFILLING -> RUNNING: deliver the first generated token, stamp
        TTFT, and insert the prompt's full pages into the radix tree."""
        req = self.slots[i]
        self._prefill_left[i] = None
        self._draft_prefill_left[i] = None
        self._prefill_tok[i] = None
        req.generated.append(tok)
        self.generated_tokens_total += 1
        if req.first_token_time is None:
            req.first_token_time = now
        self.tokens[i] = tok
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
        """Reserve a free slot for ``req``; the slot stays PREFILLING until
        ``_drive_prefill_chunks`` streams its last chunk.  False when no
        slot is free or the pool cannot cover the worst-case page need even
        after evicting unreferenced cached prefixes."""
        free = self.free_slots()
        if not free:
            return False
        if len(req.prompt) > self.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds engine "
                f"max_seq={self.max_seq}; refusing to truncate silently"
            )
        return self._begin_chunked_admit(free[0], req)

    # ------------------------------------------------------------------
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
        self._top_up_pages(k)
        tokens, cache, rem, toks_seq, steps, bad = T.decode_loop(
            self.cfg, self.params, self.tokens, self.cache,
            torch.tensor(self._remaining(), device=self.device), k=k,
            max_seq=self.max_seq, compute_dtype=self.compute_dtype,
            attn_impl=self.attn_impl,
        )
        self.tokens, self.cache = tokens, cache
        b = self.max_slots
        fetched = torch.cat([
            toks_seq.reshape(-1), steps, rem, cache["index"], bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # the single fused fetch above
        toks_np = fetched[: k * b].reshape(k, b)
        steps_np, rem_np, idx_np, bad_np = fetched[k * b:].reshape(4, b)
        if bad_np.any():
            raise FloatingPointError(
                f"non-finite logits in decode for slots {np.flatnonzero(bad_np)}"
            )
        self.steps_executed += k
        now = self.clock()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
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
        # worst case every round accepts the whole chunk
        self._top_up_pages(k * (gamma + 1))
        (
            self.tokens, self.cache, self.draft_cache, rem,
            out_toks, n_out, accepted, proposed, bad,
        ) = spec_decode_loop(
            self.cfg, self.draft_cfg, self.params, self.draft_params,
            self.tokens, self.cache, self.draft_cache,
            torch.tensor(self._remaining(), device=self.device), k=k,
            gamma=gamma, mode=self.spec_cfg.mode, max_seq=self.max_seq,
            sim_accept_p=self.spec_cfg.sim_accept_p, gen=self._spec_gen,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
        )
        b, t = self.max_slots, gamma + 1
        fetched = torch.cat([
            out_toks.reshape(-1), n_out.reshape(-1), accepted.reshape(-1),
            proposed.reshape(-1), rem, self.cache["index"], bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # the single fused fetch above
        toks_np = fetched[: k * b * t].reshape(k, b, t)
        n_np, acc_np, prop_np = fetched[k * b * t: k * b * (t + 3)].reshape(3, k, b)
        rem_np, idx_np, bad_np = fetched[k * b * (t + 3):].reshape(3, b)
        if bad_np.any():
            raise FloatingPointError(
                f"non-finite verify logits for slots {np.flatnonzero(bad_np)}"
            )
        self.steps_executed += k
        self.spec_rounds += k
        now = self.clock()
        finished = []
        self._last_spec_slot_stats = {}
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
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
            else:
                # rollback freed the positions past the accepted prefix
                self._trim_slot_pages(i)
        if self.num_prefilling:
            self._restore_draft_prefill_indices()
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers trims + retires
        return finished

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

    def _tree_round(self, prop, name: str, tree, remaining: np.ndarray,
                    gamma: int, mode: str) -> list[Request]:
        """One tree-verify round over a host proposer's candidate tree."""
        n_nodes = len(tree.parents)
        # worst case the round accepts a whole root-to-leaf path; node-index
        # K/V slots need n_nodes positions regardless
        self._top_up_pages(n_nodes)
        (
            self.tokens, self.cache, rem, out, n_out, accepted, proposed, bad,
        ) = spec_tree.tree_verify_round(
            self.cfg, self.params, self.tokens, self.cache,
            torch.tensor(tree.tail, device=self.device),
            torch.tensor(remaining, device=self.device),
            parents=tree.parents, mode=mode, max_seq=self.max_seq,
            sim_accept_p=self.spec_cfg.sim_accept_p, gen=self._spec_gen,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
        )
        b, w = out.shape
        fetched = torch.cat([
            out.reshape(-1), n_out, accepted, proposed, rem, self.cache["index"],
            bad.to(torch.int32),
        ]).cpu().numpy()
        self.d2h_transfers += 1  # one per round: proposals need the history
        toks_np = fetched[: b * w].reshape(b, w)
        n_np, acc_np, prop_np, rem_np, idx_np, bad_np = fetched[b * w:].reshape(6, b)
        if bad_np.any():
            raise FloatingPointError(
                f"non-finite verify logits for slots {np.flatnonzero(bad_np)}"
            )
        self.steps_executed += 1
        self.spec_rounds += 1
        self.obs.metrics.gauge("spec/proposer/tree_nodes").set(n_nodes)
        round_acc = round_prop = 0
        now = self.clock()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None or self.slot_prefilling(i):
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
            else:
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
        """Device bytes of the KV pools and block tables."""
        layers = self.cache["layers"]
        return sum(
            t.numel() * t.element_size()
            for t in (layers["k"], layers["v"], self.cache["block_tables"])
        )


def _to_device(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return params.to(device)

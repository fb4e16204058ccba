"""Continuous-batching inference engine on the paged, chunked, greedy path.

Counterpart of ``repro.serving.engine.InferenceEngine`` in its default
layout: KV lives in a shared pool of 16-token physical pages addressed
through per-slot block tables (``serving/kv_pool.py``), admission reserves a
slot's worst-case pages and streams the prompt as fixed 32-token chunks
through ONE batched prefill program per wave, a radix tree serves shared
page-aligned prefixes from cached pages, and decode runs ``k`` greedy
microsteps per dispatch with a single device -> host fetch at the end.

The engine keeps the compute primitives (``_admit_request``, the chunk
waves, ``_drive_decode_loop``, ``evict_slot``); the request lifecycle lives
in ``serving/core.py`` (``EngineCore``), which the ``core`` property builds.

The device is ``cuda`` unless the caller passes ``device="cpu"``; without a
CUDA device and without an explicit ``device="cpu"`` the constructor raises.
On CUDA the attention cores launch the hand-written kernels, on the CPU their
plain PyTorch versions.  The KV pool, block tables, indices and token vector
are updated in place (the reference's jit donates them).

Not in this slice: speculation, fault injection and NaN quarantine, the
dense KV layout and monolithic prefill.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import Observability
from repro_torch.serving.kv_pool import PageAllocError, PagePool, RadixCache

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
        #: per-slot prompt tokens still to stream while PREFILLING
        self._prefill_left: list[Optional[np.ndarray]] = [None] * max_slots
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

    # ------------------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def slot_prefilling(self, i: int) -> bool:
        """True while slot ``i`` still has prompt chunks to stream; such a
        slot is frozen in the decode loop and never retires mid-prefill."""
        return self._prefill_left[i] is not None

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

    def evict_slot(self, i: int, sync: bool = True) -> Request:
        """Release slot ``i`` -- pages back to the pool, index reset --
        WITHOUT finishing the request (the preempt/abort primitive; resume
        re-prefills ``prompt + generated``, mostly from radix-cached pages).
        ``sync=False`` defers the block-table upload to the caller."""
        req = self.slots[i]
        assert req is not None, f"evict of empty slot {i}"
        self.slots[i] = None
        self._prefill_left[i] = None
        self._prefill_tok[i] = None
        self.cache["index"][i] = 0
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
        self._prefill_left[slot] = np.asarray(req.prompt, np.int32)[shared:]
        self._prefill_tok[slot] = None
        self.prefill_prompt_tokens += len(req.prompt)
        self.prefill_skipped_tokens += shared
        self.slots[slot] = req
        return True

    def _plan_prefill_waves(self, budget: float):
        """Host-side preview of ``_drive_prefill_chunks``: greedy allocation
        of chunk takes, wave by wave, shortest pending stream first, under
        ``budget`` metered tokens.  Returns ``(waves, consumed, completing)``
        with each wave a list of ``(slot, take)``; deterministic, so a
        scheduler can price a step's prefill before driving it."""
        chunk = self.prefill_chunk
        left = {
            i: len(t) for i, t in enumerate(self._prefill_left)
            if t is not None and len(t)
        }
        waves, consumed, completing = [], 0, []
        budget_left = budget
        while left:
            wave = []
            for i in sorted(left, key=lambda i: (left[i], i)):
                if budget_left <= 0:
                    break
                take = min(chunk, left[i], int(min(budget_left, chunk)))
                if take <= 0:
                    continue
                wave.append((i, take))
                left[i] -= take
                budget_left -= take
                consumed += take
                if left[i] == 0:
                    completing.append(i)
                    del left[i]
            if not wave:
                break
            waves.append(wave)
        return waves, consumed, completing

    def _drive_prefill_chunks(self, budget: float = math.inf) -> int:
        """Stream chunk waves into every PREFILLING slot, consuming at most
        ``budget`` tokens.  Each wave is ONE batched dispatch over all slots
        (ragged ``chunk_lens``; 0 freezes a slot).  Slots whose prompt
        completes get their first token from the completing wave, fetched
        in ONE batched transfer at the end.  Returns tokens consumed."""
        self.last_prefill_slot_tokens = {}
        waves, consumed, _ = self._plan_prefill_waves(budget)
        if not waves:
            return 0
        for wave in waves:
            for i, take in wave:
                self.last_prefill_slot_tokens[i] = (
                    self.last_prefill_slot_tokens.get(i, 0) + take
                )
        if self._bt_dirty:
            self._sync_block_tables()  # one upload covers every admission
        chunk = self.prefill_chunk
        completed: list[int] = []
        for wave in waves:
            lens = np.zeros((self.max_slots,), np.int32)
            toks = np.zeros((self.max_slots, chunk), np.int32)
            for i, take in wave:
                buf = self._prefill_left[i]
                toks[i, :take] = buf[:take]
                lens[i] = take
                self._prefill_left[i] = buf[take:]
                self._slot_idx[i] += take
            next_toks, self.cache = T.prefill_chunks_into_slots(
                self.cfg, self.params,
                torch.tensor(toks, device=self.device),
                torch.tensor(lens, device=self.device), self.cache,
                compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
            )
            self.steps_executed += 1
            for i, _ in wave:
                if len(self._prefill_left[i]) == 0:
                    # hold the completing wave's device argmax
                    self._prefill_tok[i] = next_toks
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
        remaining = np.zeros((self.max_slots,), np.int32)
        for i, r in enumerate(self.slots):
            if r is not None and not self.slot_prefilling(i):
                remaining[i] = max(r.max_new_tokens - len(r.generated), 0)
        tokens, cache, rem, toks_seq, steps, bad = T.decode_loop(
            self.cfg, self.params, self.tokens, self.cache,
            torch.tensor(remaining, device=self.device), k=k,
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

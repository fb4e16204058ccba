"""The harness's side of the program: it builds the port's objects from the
config file and wraps the calls the window drives, timing them and marking
them as spans.  Nothing here changes what the program computes."""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.serving.engine import InferenceEngine


def model_config(cfg_file: dict) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(name=cfg_file["arch"], family="dense",
                       **{k: v for k, v in cfg_file["model"].items() if k in fields})


def train_config(cfg_file: dict) -> TrainConfig:
    t = cfg_file["train"]
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in t.items() if k in fields})


def engine(cfg: ModelConfig, cfg_file: dict, params, device) -> InferenceEngine:
    e = cfg_file["engine"]
    return InferenceEngine(cfg, params, max_slots=e["slots"], max_seq=e["max_seq"],
                           kv_page_size=e["page"], prefill_chunk=e["chunk"],
                           compute_dtype=getattr(torch, e["dtype"]), device=device)


def captures(eng: InferenceEngine, step=None) -> int:
    """Graphs captured so far by the engine and the train step."""
    n = len(eng._graphs)
    graphs = getattr(step, "graphs", None)
    return n + (graphs.captures if graphs is not None else 0)


class TimedStep:
    """The train step as the window calls it: CUDA events around each call
    (read once the window has closed) and a ``train_step`` span."""

    def __init__(self, step, tracer, device):
        self.step, self.tracer, self.device = step, tracer, device
        self.events: list = []
        self.recording = False

    @property
    def graphs(self):
        return getattr(self.step, "graphs", None)

    def __call__(self, state, batch):
        with self.tracer.span("train_step"):
            if self.recording and self.device.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = self.step(state, batch)
                b.record()
                self.events.append((a, b))
                return out
            return self.step(state, batch)

    def times_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]


class StepRecorder:
    """Wraps ``EngineCore.step``: each call's host wall, its outputs, and
    what the roofline readers need (the decoding slots' cache lengths and
    remaining budgets, the prompts it admitted), while ``recording``."""

    def __init__(self, core, tracer):
        self.core, self.tracer = core, tracer
        self.orig = core.step
        self.records: list = []
        self.recording = False
        core.step = self

    def __call__(self, grant=None):
        if not self.recording:
            with self.tracer.span("engine_step"):
                return self.orig(grant)
        core = self.core
        eng = core.engine
        decoding = [(len(cr.prompt) + len(cr.output_tokens), cr.remaining_budget)
                    for slot, cr in core.slot_requests.items() if not eng.slot_prefilling(slot)]
        waiting = {cr.request_id: len(cr.prompt) + len(cr.output_tokens)
                   for q in core.waiting.values() for cr in q}
        skipped0 = eng.prefill_skipped_tokens
        traced = self.tracer.stretch  # 0 in the window
        t0 = time.perf_counter()
        with self.tracer.span("engine_step"):
            out = self.orig(grant)
        t1 = time.perf_counter()
        self.records.append({
            "t0": t0, "t1": t1, "k": out.k, "prefill_tokens": out.prefill_tokens,
            "tokens": sum(len(o.new_tokens) for o in out.outputs),
            "decoding": decoding,
            "admitted": [waiting[r] for r in out.admitted if r in waiting],
            "skipped": eng.prefill_skipped_tokens - skipped0, "traced": traced,
        })
        return out


def release() -> None:
    """Return the memory of objects the caller has dropped to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

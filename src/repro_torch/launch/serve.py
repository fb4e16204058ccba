"""Serving CLI of the port: the EngineCore request lifecycle under Poisson load.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --proposer ngram
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --proposer auto
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --journal j.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --journal j.jsonl --restore

Counterpart of ``repro.launch.serve``: all requests are submitted up front
(ONLINE priority, explicit arrival times) and the loop calls
``core.step()`` until every request finishes.  Weights come from the port's
own seeded init (the draft model's from ``--seed + 1``).  ``--proposer``
turns on speculation: ``ngram`` verifies host-proposed n-gram trees without
a draft model, ``draft`` pairs the target with ``draft_config``'s draft
model, ``auto`` registers both and routes per quantum.  An attention
family (dense: qwen3-1.7b, olmo-1b, qwen2-7b, deepseek-coder-33b; MoE:
moonshot-v1-16b-a3b, dbrx-132b; audio: musicgen-large; VLM: pixtral-12b)
serves on the paged KV layout with chunked prefill, its weights made in
bf16 on the device (moonshot's 28 B parameters are 56 GB there,
deepseek-coder-33b's 67 GB, pixtral-12b's 24.5 GB); the audio and VLM
configs' prompts are token ids (EnCodec codes, text) through the
reference's stub frontend, which embeds a monolithic prefill's tokens
with the embedding table; falcon-mamba-7b
(Mamba1) and zamba2-2.7b (Mamba2 layers with a shared attention block) on
dense rows with monolithic bucket prefill, speculating with their
recurrent draft model under ``draft`` / ``auto`` (``ngram``, a host
proposer, needs an attention family: on these two it registers nothing
and the run decodes plainly, as the reference's CLI does).  The run is on
``cuda`` unless ``--device cpu`` is given;
without a CUDA device the default raises.  The end-of-run summary reads the
metrics registry under the reference's stable names; ``--trace PREFIX``
also writes the step trace as ``PREFIX.jsonl`` and ``PREFIX.chrome.json``.
``--journal PATH`` logs every submit, transition, token delta and finish to
a write-ahead journal (fsync'd every ``--journal-fsync-interval`` records);
``--restore`` first replays that journal, so a killed run's unfinished
requests re-enter the queue (mid-flight ones PREEMPTED) and finish as they
would have.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import SpecDecodeConfig, draft_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.core import Priority, SamplingParams
from repro_torch.serving.engine import InferenceEngine


def summarize(engine: InferenceEngine) -> list:
    """Render the registry's end-of-run summary lines."""
    m = engine.obs.metrics
    lines = []
    reasons = {
        r: m.counter(f"core/finish_reason/{r}").value
        for r in ("stop", "length", "abort", "expired", "error")
    }
    lines.append(
        "[serve] finish reasons: "
        + " ".join(f"{k}={v}" for k, v in reasons.items())
        + f"; preemptions={m.counter('core/preemptions').value}"
    )
    peaks = []
    for name in (
        "core/queue_depth/online", "core/queue_depth/offline",
        "engine/slots_active", "engine/pool/pages_in_use",
    ):
        gauge = m.gauge(name)
        if gauge.samples:
            peaks.append(f"{name.split('/', 1)[1]} peak={gauge.max:g}")
    if peaks:
        lines.append("[serve] gauges: " + "; ".join(peaks))
    for name in ("core/online_latency_s", "core/online_ttft_s"):
        h = m.histogram(name)
        if h.count:
            label = name.rsplit("/", 1)[1].replace("_s", "")
            lines.append(
                f"[serve] {label}: n={h.count} "
                f"p50={h.percentile(50)*1e3:.1f}ms "
                f"p95={h.percentile(95)*1e3:.1f}ms "
                f"max={h.max*1e3:.1f}ms"
            )
    # one row per proposer that ran
    for prop in ("draft", "ngram", "suffix"):
        rounds = m.counter(f"spec/proposer/rounds/{prop}").value
        if rounds:
            lines.append(
                f"[serve] proposer {prop}: rounds={rounds} "
                f"proposed={m.counter(f'spec/proposer/proposed/{prop}').value} "
                f"accepted={m.counter(f'spec/proposer/accepted/{prop}').value} "
                f"acceptance={m.gauge(f'spec/proposer/acceptance/{prop}').value:.3f}"
            )
    switches = m.counter("spec/proposer/router_switches").value
    fallbacks = m.counter("spec/proposer/no_match_fallbacks").value
    if switches or fallbacks:
        lines.append(
            f"[serve] proposer routing: switches={switches} "
            f"no_match_fallbacks={fallbacks}"
        )
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS), default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--mean-interval-ms", type=float, default=20.0)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument(
        "--deadline-ms", type=float, default=None,
        help="queue TTL per request; WAITING past it finishes 'expired'",
    )
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--trace", metavar="PREFIX", default=None,
        help="write the step trace to PREFIX.jsonl + PREFIX.chrome.json",
    )
    ap.add_argument(
        "--journal", metavar="PATH", default=None,
        help="write-ahead request journal (append-only JSONL): submits, "
        "transitions, token deltas and finishes, so a killed run can be "
        "recovered with --restore",
    )
    ap.add_argument(
        "--journal-fsync-interval", type=int, default=8,
        help="group commit: fsync the journal every N records (a crash "
        "loses at most the last N appends)",
    )
    ap.add_argument(
        "--restore", action="store_true",
        help="replay the --journal file before submitting fresh work: a "
        "previous run's unfinished requests re-enter the queue (mid-flight "
        "ones as PREEMPTED) and finish byte-identically",
    )
    ap.add_argument(
        "--proposer", choices=("auto", "draft", "ngram", "none"), default="none",
        help="speculation source: 'ngram' is host-only (no draft model); "
        "'draft' / 'auto' also build a draft pairing; 'auto' routes between "
        "them per quantum",
    )
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dtype=torch.bfloat16)
    spec_kw = {}
    if args.proposer != "none":
        spec = SpecDecodeConfig(proposer=args.proposer)
        spec_kw["spec"] = spec
        if args.proposer in ("auto", "draft"):
            dcfg = draft_config(cfg, spec)
            dgen = torch.Generator(device=device).manual_seed(args.seed + 1)
            spec_kw["draft_cfg"] = dcfg
            spec_kw["draft_params"] = T.init_params(dcfg, dgen, dtype=torch.bfloat16)
    t0 = time.monotonic()
    # single clock source: engine timestamps share the arrival timebase
    engine = InferenceEngine(
        cfg, params, max_slots=args.slots, max_seq=args.max_seq,
        clock=lambda: time.monotonic() - t0, device=device, **spec_kw,
    )
    engine.obs.tracer.enabled = args.trace is not None
    core = engine.core

    journal = None
    if args.journal is not None:
        from repro_torch.resilience import RequestJournal

        journal = RequestJournal(args.journal, fsync_interval=args.journal_fsync_interval)
        if args.restore:
            report = journal.recover_into(core)
            print(
                f"[serve] restored {report.restored} requests "
                f"({report.resumed_inflight} mid-flight, "
                f"{report.replayed_tokens} tokens replayed, "
                f"{report.skipped_finished} already finished) from {args.journal}"
            )
        journal.attach(core)
    elif args.restore:
        raise SystemExit("--restore requires --journal PATH")

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(args.mean_interval_ms / 1e3, args.requests))
    requests = [
        core.submit(
            rng.integers(0, cfg.vocab_size, args.prompt_len),
            SamplingParams(
                max_new_tokens=args.max_new_tokens,
                deadline_s=(
                    None if args.deadline_ms is None else args.deadline_ms / 1e3
                ),
            ),
            priority=Priority.ONLINE,
            arrival_time=float(arrivals[i]),
        )
        for i in range(args.requests)
    ]
    while core.has_unfinished:
        out = core.step()
        if out.k == 0 and not out.admitted:
            time.sleep(0.001)  # idle until the next arrival
    if journal is not None:
        journal.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_tokens = sum(len(r.output_tokens) for r in requests)
    dt = time.monotonic() - t0
    print(
        f"[serve] {len(requests)} requests, {total_tokens} tokens in "
        f"{dt:.2f}s ({total_tokens/dt:.1f} tok/s)"
    )
    for line in summarize(engine):
        print(line)
    if args.trace is not None:
        tr = engine.obs.tracer
        tr.write_jsonl(args.trace + ".jsonl", metrics=engine.obs.metrics.snapshot())
        tr.write_chrome(args.trace + ".chrome.json")
        print(
            f"[serve] trace: {args.trace}.jsonl ({len(tr.events)} events, "
            f"{tr.dropped} dropped); {args.trace}.chrome.json"
        )


if __name__ == "__main__":
    main()

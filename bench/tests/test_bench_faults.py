"""A whole run of each cell, shrunk to a CPU size, with the timed path
broken underneath: ``correct`` must come out false under the cell's limits
(the look for a card is skipped, nothing else).  Faults: a train step that
returns its state unchanged, a train step that leaves out half of the batch
(the mean over the rest), a served token altered where the core takes it
from the engine, and half of the batch left out of the graph replays alone
(the steps after the first).  One chip, so no exchange between chips to
leave out."""
import torch

import run
from repro_torch.models import transformer as T
from repro_torch.serving.core import EngineCore

BIG = 4_000_000_019


def tiny(ctx):
    m = ctx.config["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128, vocab_size=256,
             num_kv_heads=2 if m["qk_norm"] else 4)
    ctx.config["train"].update(batch=8, seq_len=192)
    ctx.config["engine"].update(max_seq=256, slots=4)
    mix = ctx.mix
    mix["offline"]["prompt"].update(median=24, min=8, max=64)
    mix["offline"]["output"].update(min=8, max=40)
    mix["offline"]["waiting"] = 4
    mix["check_tokens"] = 64
    if "online" in mix:
        mix["online"]["prompt"].update(median=16, min=4, max=32)
        mix["online"]["output"].update(min=4, max=16)
        mix["online"]["rate"] = 20.0
        mix.update(warmup_min_seconds=0.5, warmup_max_seconds=2.0, drain_seconds=20.0)
    else:
        mix.update(probe_slots=4, train_batches=4)


def measure(cell, seconds=3.0):
    args = run.parse(["--workload", cell, "--seed", str(BIG), "--seconds", str(seconds)])
    return run.measure(args, device=torch.device("cpu"), adjust=tiny)



def patch_step(monkeypatch, kind):
    from repro_torch import runtime

    real = runtime.make_train_step

    def make(cfg, tcfg, **kw):
        art = real(cfg, tcfg, **kw)

        calls = []

        def step(state, batch):
            calls.append(1)
            if kind == "replays_half" and len(calls) == 1:
                return art(state, batch)
            if kind == "unchanged":
                with torch.no_grad():
                    loss, _ = T.lm_loss(cfg, state["params"], torch.as_tensor(batch["inputs"]),
                                        torch.as_tensor(batch["labels"]), impl="torch")
                return state, {"loss": loss}
            rows = batch["inputs"].shape[0] // 2
            return art(state, {k: v[:rows] for k, v in batch.items()})

        return type("Broken", (), {"jitted": staticmethod(lambda: step)})()

    monkeypatch.setattr(runtime, "make_train_step", make)


def test_sound_collocate_run_reads_small_gaps():
    res = measure("qwen3-1.7b.fill-offline")
    n = res["record"]["numbers"]
    assert n["served_tokens_checked"] > 0
    assert n["loss_rel_gap"] < 1e-3 and n["change_leaf_gap"] < 1e-2


def test_state_left_unchanged_fails(monkeypatch):
    patch_step(monkeypatch, "unchanged")
    res = measure("qwen3-1.7b.fill-offline")
    assert res["correct"] is False
    n = res["record"]["numbers"]
    assert n["first_grad_leaf_gap"] > 0.99 and n["second_grad_leaf_gap"] > 0.99
    assert n["change_leaf_gap"] > 0.99


def test_half_batch_fails(monkeypatch):
    patch_step(monkeypatch, "half")
    res = measure("qwen3-1.7b.fill-offline")
    assert res["correct"] is False


def test_half_batch_in_the_replayed_steps_alone_fails(monkeypatch):
    # the first call is the graphed step's eager warm-up: a fault confined
    # to the steps after it shows in step 2's gradient
    patch_step(monkeypatch, "replays_half")
    res = measure("qwen3-1.7b.fill-offline")
    assert res["correct"] is False
    n = res["record"]["numbers"]
    assert n["first_grad_leaf_gap"] < 1e-3
    assert n["second_grad_leaf_gap"] > res["checks"]["second_grad_leaf_gap"]["limit"]


def test_altered_token_fails(monkeypatch):
    real = EngineCore._collect

    def collect(self, cr):
        first = not cr.output_tokens
        new = real(self, cr)
        if first and new:  # each request's first token, altered as it is taken
            new[0] = (new[0] + 1) % self.engine.cfg.vocab_size
            cr.output_tokens[-len(new)] = new[0]
        return new

    monkeypatch.setattr(EngineCore, "_collect", collect)
    res = measure("olmo-1b.serve-online")
    assert res["correct"] is False
    assert res["record"]["numbers"]["served_logit_gap"] > 0.1

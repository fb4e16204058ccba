#!/usr/bin/env python3
"""Three train steps at full width in both packages, on the CPU in fp32.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/parity_fullwidth_loss.py [--pixtral]

A one-off check, not a tier-1 test.  On the card, zamba2-2.7b's,
musicgen-large's and pixtral-12b's training losses rise at step 3, the first
step at the schedule's full learning rate (3e-4 after 2 warm-up steps); their
steps match the reference at smoke width.  This runs each config at its
published width with its depth cut (2 layers; zamba2's shared attention
block every 2 of them instead of every 6), on short sequences (2 x 64
tokens, or the stub frontend's embeddings), through the port's
``make_train_step`` and the reference's loss, clip, schedule and AdamW
jitted together (its own ``make_train_step`` fails on this JAX), from the
same weights and batches, with ``TrainConfig(warmup_steps=2,
total_steps=5)`` as the card's train phases use.  It prints each step's
loss, grad norm and lr in both, and whether they agree (loss and grad norm
within 1e-4 relative).

pixtral-12b (``--pixtral``) holds a 131072 x 5120 embedding table and head:
with their gradients and AdamW moments, ~22 GB a package.  Run it only on
a host with that much memory to spare.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule

RTOL = 1e-4
STEPS = 3
SEQ, BATCH = 64, 2
TRAIN_KW = dict(warmup_steps=2, total_steps=STEPS + 2, compute_dtype="float32")


def _cut(cfg, layers=2):
    kw = {"num_layers": layers}
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = layers
    return dataclasses.replace(cfg, **kw)


def _reference_steps(jcfg, np_params, batches):
    jtcfg = JTrainConfig(**TRAIN_KW)
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def jstep(state, batch):
        def loss_fn(p):
            return JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"], impl="xla",
                              compute_dtype=jnp.float32)

        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g, gnorm = jclip(jax.tree.map(lambda x: x.astype(jnp.float32), g), jtcfg.grad_clip_norm)
        lr = sched(state["opt"]["step"])
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=lr, cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, (loss, gnorm, lr)

    params = jax.tree.map(jnp.asarray, np_params)
    state = {"params": params, "opt": jadamw_init(params)}
    out = []
    for batch in batches:
        state, (loss, gnorm, lr) = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(loss), float(gnorm), float(lr)))
    return out


def _port_steps(arch, np_params, batches):
    import torch

    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import TrainConfig
    from repro_torch.runtime import init_train_state, make_train_step

    torch.manual_seed(0)
    cfg = _cut(configs.get_config(arch))
    step = make_train_step(cfg, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(np_params, device="cpu"))
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((m["loss"].item(), m["grad_norm"].item(), m["lr"].item()))
    return out


def check(arch: str) -> bool:
    t0 = time.monotonic()
    jcfg = _cut(jconfigs.get_config(arch))
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    n = sum(x.size for x in jax.tree.leaves(np_params))
    ds = JDataset(jcfg, seq_len=SEQ, global_batch=BATCH, seed=7)
    batches = [ds.next_batch() for _ in range(STEPS)]
    ref = _reference_steps(jcfg, np_params, batches)
    port = _port_steps(arch, np_params, batches)
    ok = True
    print(f"{arch}: {jcfg.num_layers} layers at d_model {jcfg.d_model}, {n / 1e6:.1f} M params, "
          f"{BATCH} x {SEQ}, fp32, {time.monotonic() - t0:.0f} s")
    for i, ((rl, rg, rlr), (pl, pg, plr)) in enumerate(zip(ref, port), 1):
        dl, dg = abs(pl - rl) / abs(rl), abs(pg - rg) / abs(rg)
        agree = dl <= RTOL and dg <= RTOL
        ok &= agree
        print(f"  step {i}: lr {plr:.3e} (reference {rlr:.3e}); loss {pl:.6f} vs {rl:.6f} "
              f"(rel {dl:.1e}); grad norm {pg:.5f} vs {rg:.5f} (rel {dg:.1e})"
              f"{'' if agree else '  DISAGREE'}")
    rises = [port[i][0] > port[i - 1][0] for i in range(1, STEPS)]
    print(f"  {'agree' if ok else 'DISAGREE'}; loss rises at step(s) "
          f"{[i + 2 for i, r in enumerate(rises) if r] or 'none'} in the port, "
          f"{[i + 2 for i in range(STEPS - 1) if ref[i + 1][0] > ref[i][0]] or 'none'} "
          f"in the reference", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pixtral", action="store_true",
                    help="also pixtral-12b (~22 GB a package; see the module doc)")
    args = ap.parse_args()
    archs = ["zamba2-2.7b", "musicgen-large"] + (["pixtral-12b"] if args.pixtral else [])
    results = [check(a) for a in archs]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Development smoke run of the port (the counterpart of
``scripts/dev_smoke.py``): every smoke arch's forward, ``lm_loss`` (remat
"dots"), prefill into a 64-row cache and one decode step, from the port's
seeded init, with the real parameter count against the analytic one.

    PYTHONPATH=src python scripts/torch_dev_smoke.py                  # cuda
    PYTHONPATH=src python scripts/torch_dev_smoke.py --device cpu qwen3-1.7b

Prints one line an arch; exits non-zero when a count differs from the
analytic one or a loss or decode logit is not finite.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

BATCH, SEQ, MAX_SEQ = 2, 32, 64


def smoke(arch: str, device: torch.device) -> dict:
    """One arch's forward, loss, prefill and decode step: ``{"loss",
    "real", "analytic", "diff", "decode_ok", "logits"}``."""
    cfg = configs.smoke_config(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen)
    n_real = sum(t.numel() for t in tree_leaves(params))
    n_analytic = cfg.param_count()
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device=device)
    inputs = (torch.randn((BATCH, SEQ, cfg.d_model), generator=gen, device=device)
              if cfg.embed_inputs else tokens)
    with torch.no_grad():
        T.forward(cfg, params, inputs)
        loss, _ = T.lm_loss(cfg, params, inputs, tokens, remat_policy="dots")
        logits, cache = T.prefill(cfg, params, inputs, MAX_SEQ)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        logits2, cache = T.decode_step(cfg, params, nxt, cache)
    ok = bool(torch.isfinite(loss)) and bool(torch.isfinite(logits2).all())
    return {"loss": float(loss), "real": n_real, "analytic": n_analytic,
            "diff": abs(n_real - n_analytic), "decode_ok": ok,
            "logits": tuple(logits2.shape)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("archs", nargs="*", help="archs to run (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.archs) - set(configs.ARCH_IDS))
    if unknown:
        ap.error(f"unknown archs {unknown}; known: {list(configs.ARCH_IDS)}")
    device = resolve_device(args.device)
    failures = 0
    for arch in args.archs or configs.ARCH_IDS:
        r = smoke(arch, device)
        print(f"{arch:24s} loss={r['loss']:8.4f} params real={r['real']} "
              f"analytic={r['analytic']} diff={r['diff']} decode_ok={r['decode_ok']} "
              f"logits={r['logits']}")
        failures += r["diff"] != 0 or not r["decode_ok"]
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

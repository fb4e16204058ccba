"""The comparisons that decide ``correct``: the program's outputs against the
plain reference (``bench/reference``), run once the window has closed and
the program's state is freed, on weights the benchmark makes again from the
seed.

Training: each of the first three steps' loss; each leaf's gradient norm as
the optimizer got it in step 1 (from its first moment) and in step 2 (from
the sums of its second moments after steps 1 and 2); each leaf's change over
the three steps.
A leaf's gap is the distance between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose step-1 gradient in the reference is under a thousandth of the
median leaf's (nought to rounding) are left out of the change.

Serving: for each sampled request, the reference runs once over the prompt
and the served tokens; the gap of a served token is how far its logit lies
below the reference's best at that position; the number is the widest gap.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from harness import traffic, weights
from reference.model import forward
from reference.train import train_steps


def exact_fp32() -> None:
    """float32 products in float32: no TF32 on this card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True))


def leaf_gap(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """(worst gap, its leaf) over the leaves in ``keep``."""
    med = statistics.median(ref[k] for k in keep)
    worst = max(keep, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def moving_leaves(ref_grads: dict) -> list:
    med = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= 1e-3 * med]


def sum64(t: torch.Tensor) -> float:
    """The sum of a tensor's elements, accumulated in float64 a slice at a
    time."""
    parts = t.detach().reshape(-1).split(1 << 24)
    return torch.stack([c.double().sum() for c in parts]).sum().item()


def read_optimizer(prog: dict, opt: dict, step: int, beta1: float, beta2: float) -> None:
    """Into ``prog``, after the program's step ``step`` (1 or 2), that
    step's gradient norms as its AdamW state holds them: step 1's from the
    first moment (mu = (1 - beta1) g), step 2's from the sums of the second
    moments (sum nu2 = beta2 sum nu1 + (1 - beta2) |g2|^2)."""
    nu = {k: sum64(v) for k, v in weights.flat(opt["nu"]).items()}
    if step == 1:
        prog["first_grad_norms"] = {k: (v.norm() / (1.0 - beta1)).item()
                                    for k, v in weights.flat(opt["mu"]).items()}
        prog["nu_sums"] = nu
        return
    nu1 = prog.pop("nu_sums")
    prog["second_grad_norms"] = {k: math.sqrt(max(s - beta2 * nu1[k], 0.0) / (1.0 - beta2))
                                 for k, s in nu.items()}


def change_norms(m: dict, seed: int, params: dict, device) -> dict:
    """``{path: |p - p0|}``, the initial leaf made again one at a time."""
    out = {}
    for i, (path, _, _) in enumerate(weights.leaves(m)):
        p0 = weights.leaf(m, seed, i, device)
        out[path] = (params[path].detach().float() - p0).norm().item()
        del p0
    return out


def reference_training(m: dict, train: dict, seed: int, batches: list, device, *,
                       mode: str = "fp32", rows: slice = slice(None)) -> dict:
    """The reference's three steps from the seed's weights: losses,
    step-1 and step-2 gradient norms, change norms.  ``mode``/``rows`` put a lower
    precision or half of each batch in the program's place (the control
    and a planted fault)."""
    params = {p: weights.leaf(m, seed, i, device) for i, (p, _, _) in enumerate(weights.leaves(m))}
    cut = [{k: v[rows] for k, v in b.items()} for b in batches]
    out = train_steps(m, train, params, cut, mode=mode)
    out["change"] = change_norms(m, seed, params, device)
    del params
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return out


def training_gaps(prog: dict, ref: dict) -> dict:
    """The four training numbers of ``prog`` (losses, first_grad_norms,
    second_grad_norms, change) against ``ref``."""
    keep = moving_leaves(ref["first_grad_norms"])
    return {"loss_rel_gap": loss_gap(prog["losses"], ref["losses"]),
            "first_grad_leaf_gap": leaf_gap(prog["first_grad_norms"], ref["first_grad_norms"],
                                            list(ref["first_grad_norms"]))[0],
            "second_grad_leaf_gap": leaf_gap(prog["second_grad_norms"], ref["second_grad_norms"],
                                             list(ref["second_grad_norms"]))[0],
            "change_leaf_gap": leaf_gap(prog["change"], ref["change"], keep)[0]}


def sample(served: list, seed: int, want_tokens: int) -> list:
    """The longest served request and others drawn from the seed until the
    sample holds ``want_tokens`` served tokens.  ``served``: ``(prompt,
    output tokens)`` pairs."""
    served = [s for s in served if len(s[1])]
    if not served:
        return []
    order = traffic.rng(seed, "sample").permutation(len(served)).tolist()
    longest = max(range(len(served)), key=lambda i: len(served[i][1]))
    picked, total = [], 0
    for i in [longest] + [i for i in order if i != longest]:
        picked.append(served[i])
        total += len(served[i][1])
        if total >= want_tokens:
            break
    return picked


def served_gaps(m: dict, seed: int, picked: list, device, *, control: bool = False) -> dict:
    """The widest gap of the served tokens under the float32 reference over
    the served (bfloat16) weights; with ``control``, also the widest gap of
    the tokens the float8 reference puts first at the same positions."""
    params = {p: weights.leaf(m, seed, i, device, torch.bfloat16).float()
              for i, (p, _, _) in enumerate(weights.leaves(m))}
    widest, widest_ctl, n = 0.0, 0.0, 0
    with torch.no_grad():
        for prompt, out in picked:
            seq = torch.as_tensor(np.concatenate([prompt, out]).astype(np.int64), device=device)
            at = torch.arange(len(prompt) - 1, len(seq) - 1, device=device)
            ref = forward(m, params, seq[None])[0, at]
            best = ref.max(-1).values
            served = ref.gather(-1, seq[at + 1][:, None])[:, 0]
            widest = max(widest, (best - served).max().item())
            n += len(out)
            if control:
                low = forward(m, params, seq[None], mode="fp8")[0, at].argmax(-1)
                ctl = ref.gather(-1, low[:, None])[:, 0]
                widest_ctl = max(widest_ctl, (best - ctl).max().item())
            del ref
    del params
    # nothing served is nothing checked: that run cannot pass
    res = {"served_logit_gap": widest if n else math.nan, "served_tokens_checked": n}
    if control:
        res["control_served_logit_gap"] = widest_ctl
    return res


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``) over the numbers that have
    a limit; a number that is missing or not finite fails."""
    checks = {k: {"value": numbers.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks

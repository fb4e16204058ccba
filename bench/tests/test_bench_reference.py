"""The plain reference against the port at a smoke size, float32, on the
CPU: the same weights (the benchmark's) give the same logits and the same
three training steps."""
import json

import pytest
import torch

from harness import check, program, traffic, weights
from reference.model import forward, q8
from reference.train import train_steps
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.runtime.step import abstract_params

CELLS = ("qwen3-1.7b", "olmo-1b")


def small(name):
    from conftest import BENCH
    f = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    f["model"].update(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=96,
                      vocab_size=211, num_kv_heads=2 if f["model"]["qk_norm"] else 4)
    f["train"].update(batch=4, seq_len=24, compute_dtype="float32")
    return f


@pytest.mark.parametrize("name", CELLS)
def test_weight_tree_is_the_ports(name):
    f = json.loads((__import__("conftest").BENCH / "configs" / f"{name}.json").read_text())
    ref = weights.flat(abstract_params(program.model_config(f)))
    mine = weights.leaves(f["model"])
    assert [p for p, _, _ in mine] == list(ref)
    assert all(tuple(ref[p].shape) == s for p, s, _ in mine)


@pytest.mark.parametrize("name", CELLS)
def test_weights_repeat_per_seed_and_leaf(name):
    m = small(name)["model"]
    a = weights.make(m, 2**40 + 3, "cpu")
    b = weights.leaf(m, 2**40 + 3, 1, "cpu")
    assert torch.equal(weights.flat(a)["layers/attn/wq"], b)
    c = weights.leaf(m, 2**40 + 4, 1, "cpu")
    assert not torch.equal(b, c)
    half = weights.leaf(m, 2**40 + 3, 1, "cpu", torch.bfloat16)
    assert torch.equal(half, b.to(torch.bfloat16))


@pytest.mark.parametrize("name", CELLS)
def test_forward_matches_the_port(name):
    f = small(name)
    m = f["model"]
    params = weights.make(m, 5, "cpu")
    tokens = torch.as_tensor(traffic.train_batches(m["vocab_size"], 2, 24, 1, 5)[0]["inputs"])
    want, _ = T.forward(program.model_config(f), params, tokens, impl="torch",
                        compute_dtype=torch.float32)
    got = forward(m, weights.flat(params), tokens)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    low = forward(m, weights.flat(params), tokens, mode="fp8")
    assert (low - want).abs().max() > 100 * (got - want).abs().max()


@pytest.mark.parametrize("name", CELLS)
def test_three_training_steps_match_the_port(name):
    f = small(name)
    m, t = f["model"], f["train"]
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in traffic.train_batches(m["vocab_size"], 4, 24, 3, 9)]
    state = init_train_state(weights.make(m, 9, "cpu"))
    step = make_train_step(program.model_config(f), program.train_config(f), device="cpu")
    prog = {"losses": []}
    for i, b in enumerate(batches):
        state, out = step(state, b)
        prog["losses"].append(float(out["loss"]))
        if i < 2:
            check.read_optimizer(prog, state["opt"], i + 1, t["beta1"], t["beta2"])
    prog["change"] = check.change_norms(m, 9, weights.flat(state["params"]), "cpu")
    ref = check.reference_training(m, t, 9, batches, "cpu")
    gaps = check.training_gaps(prog, ref)
    assert set(gaps) == {"loss_rel_gap", "first_grad_leaf_gap", "second_grad_leaf_gap",
                         "change_leaf_gap"}
    assert all(v < 1e-4 for v in gaps.values()), gaps
    assert all(v > 0 for v in ref["change"].values())


def test_q8_rounds_to_e4m3():
    x = torch.linspace(-3, 3, 101)
    y = q8(x)
    assert (y - x).abs().max() > 1e-3 and (y - x).abs().max() < 0.07 * 3
    s = 448.0 / 3
    assert torch.allclose((y * s).to(torch.float8_e4m3fn).float(), y * s, rtol=1e-5)

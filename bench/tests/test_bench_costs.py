"""The frozen formulas of ``bench/costs`` against the port's own
``kernels/cost.py`` and ``ModelConfig`` at both cells' shapes."""
import json

import pytest
import torch

from costs import kernels as K
from costs import model as C
from harness import program
from repro_torch.kernels import cost

CELLS = ("qwen3-1.7b", "olmo-1b")


def _cfg(name):
    from conftest import BENCH
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CELLS)
def test_flash_matches_the_port(name):
    f = _cfg(name)
    m, t = f["model"], f["train"]
    shape = (t["batch"], m["num_heads"], t["seq_len"], m["head_dim"])
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    for mine, theirs in ((K.flash_fwd, cost.flash_fwd), (K.flash_bwd, cost.flash_bwd)):
        c = theirs(q, q, q, causal=True)
        assert mine(*shape) == (c.flops, c.bytes)


@pytest.mark.parametrize("name", CELLS)
def test_paged_kernels_match_the_port(name):
    f = _cfg(name)
    m, e = f["model"], f["engine"]
    b, h, kvh, hd, page = e["slots"], m["num_heads"], m["num_kv_heads"], m["head_dim"], e["page"]
    cols = e["max_seq"] // page + 1
    tables = torch.arange(1, b * cols + 1, dtype=torch.int32).reshape(b, cols)
    pool = torch.empty((b * cols + 1, page, kvh, hd), dtype=torch.bfloat16, device="meta")
    lengths = [300, 17, 0, 1024, 2000, 5, 64, 129]
    c = cost.paged_decode(torch.empty((b, h, hd), dtype=torch.bfloat16, device="meta"), pool,
                          pool, tables, torch.tensor(lengths, dtype=torch.int32))
    assert K.paged_decode(b, h, kvh, hd, lengths, cols) == (c.flops, c.bytes)
    chunk = e["chunk"]
    starts, lens = [0, 32, 0, 96, 0, 0, 480, 0], [32, 32, 7, 32, 0, 0, 17, 0]
    c = cost.paged_prefill(torch.empty((b, chunk, h, hd), dtype=torch.bfloat16, device="meta"),
                           pool, pool, tables, torch.tensor(starts), torch.tensor(lens))
    chunks = [(s, n) for s, n in zip(starts, lens) if n]
    assert K.paged_prefill(b, chunk, h, kvh, hd, chunks, cols) == (c.flops, c.bytes)


@pytest.mark.parametrize("name", CELLS)
def test_model_counts_match_the_config(name):
    f = _cfg(name)
    m = f["model"]
    cfg = program.model_config(f)
    norms = (m["num_layers"] * 2 * m["head_dim"] if m["qk_norm"] else 0) + (
        (2 * m["num_layers"] + 1) * m["d_model"] if m["parametric_norm"] else 0)
    assert C.matmul_params(m) == cfg.param_count() - norms
    t = f["train"]
    tokens = t["batch"] * t["seq_len"]
    dense = 6 * C.matmul_params(m) * tokens
    assert dense < C.train_step_flops(m, t["batch"], t["seq_len"]) < 1.1 * dense


def test_decode_bound_takes_the_larger_term():
    m = _cfg("olmo-1b")["model"]
    few = C.decode_step_bound_s(m, [100] * 8)
    assert few == pytest.approx((C.weight_bytes(m) + C.kv_bytes_per_token(m) * 800)
                                / C.HBM_BYTES_PER_S)
    many = C.decode_step_bound_s(m, [10] * 4096)
    assert many == pytest.approx(C.tokens_flops(m, 4096, 40960) / C.PEAK_BF16_FLOPS)

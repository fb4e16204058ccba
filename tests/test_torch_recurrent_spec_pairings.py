"""The port's engine on the mixed pairings of an attention model and a
recurrent one against the reference, on the CPU in fp32: the pairings the
reference's engine accepts (an attention target, qwen3-1.7b, with a Zamba2
hybrid draft on monolithic prefill; a hybrid target with an attention
draft) give its every step's outputs, streams and speculation counters;
what it refuses (a recurrent draft streaming an attention target's chunked
prefill: its chunk program asserts at the first wave) the port refuses, at
construction.  The scenario is ``tests/test_torch_recurrent_spec_engine.py``'s."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import draft_config as jdraft_config
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs import draft_config
from test_torch_recurrent_spec_engine import _engine, _serve


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mixed_pairings_match_reference():
    """An attention target (qwen3-1.7b) with a hybrid draft and a hybrid
    target with an attention draft, on monolithic prefill, give the
    reference's streams; the attention target's default chunked prefill
    cannot stream a recurrent draft: the reference's chunk program asserts
    at the first wave, the port refuses at construction."""
    qj, qt = jconfigs.smoke_config("qwen3-1.7b"), configs.smoke_config("qwen3-1.7b")
    hj, ht = jconfigs.smoke_config("zamba2-2.7b"), configs.smoke_config("zamba2-2.7b")
    hj, ht = (dataclasses.replace(jdraft_config(hj), vocab_size=qj.vocab_size),
              dataclasses.replace(draft_config(ht), vocab_size=qt.vocab_size))
    qdj, qdt = jdraft_config(qj), draft_config(qt)
    tgt_h = jax.tree.map(np.array, JT.init_params(
        dataclasses.replace(jconfigs.smoke_config("zamba2-2.7b"), vocab_size=qj.vocab_size),
        jax.random.PRNGKey(0)))
    q_params = jax.tree.map(np.array, JT.init_params(qj, jax.random.PRNGKey(0)))
    h_draft = jax.tree.map(np.array, JT.init_params(hj, jax.random.PRNGKey(5)))
    q_draft = jax.tree.map(np.array, JT.init_params(qdj, jax.random.PRNGKey(6)))
    hyb_j = dataclasses.replace(jconfigs.smoke_config("zamba2-2.7b"), vocab_size=qj.vocab_size)
    hyb_t = dataclasses.replace(configs.smoke_config("zamba2-2.7b"), vocab_size=qt.vocab_size)
    cases = (
        ((qj, hj), (qt, ht), (q_params, h_draft), dict(prefill_chunk=0)),
        ((hyb_j, qdj), (hyb_t, qdt), (tgt_h, q_draft), {}),
    )
    for jc, tc, ps, kw in cases:
        jsteps, jstreams, jcounts = _serve("jax", jc, ps, "draft", **kw)
        tsteps, tstreams, tcounts = _serve("torch", tc, ps, "draft", **kw)
        assert tstreams == jstreams and tsteps == jsteps and tcounts == jcounts
        assert tcounts[0] > 0
    with pytest.raises(ValueError, match="attention draft"):
        _engine("torch", (qt, ht), (q_params, h_draft), "draft", None)
    with pytest.raises(Exception):
        _serve("jax", (qj, hj), (q_params, h_draft), "draft")

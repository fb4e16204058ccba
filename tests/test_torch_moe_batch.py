"""Batch coupling and collocated filling on the Mixture-of-Experts family,
the port against the reference, on the CPU in fp32.

* Slot coupling: a decode step routes every slot's token as ONE group, so
  through expert capacity a request's stream depends on the requests beside
  it (idle slots included, with the tokens the engine keeps for them).  At
  12 slots (a group of 12 tokens, 24 choices, 8 slots an expert) the
  reference's stream for one request changes between serving it alone and
  serving it among 11 others; the port's changes identically, on the paged
  and the dense layout.
* ``SpecInFRuntime`` with a moonshot-smoke engine and the port's trainer
  (``make_train_step``; for the reference the same composition of
  ``repro.optim`` jitted around its loss): phase counts, filled work, every
  stream and the losses (1e-5 relative, fp32) equal the reference
  runtime's, the MoE aux term rides the loss, and the filled streams of the
  requests that were never preempted equal a plain ``EngineCore`` run's
  over the same requests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.configs.base import SpecInFConfig as JSpecInFConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import profiles as jprofiles
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecInFConfig, TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

ARCH = "moonshot-v1-16b-a3b"
JCFG, CFG = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(pkg, **kw):
    if pkg == "jax":
        return JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS),
                       compute_dtype=jnp.float32, **kw)
    return TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"),
                   compute_dtype=torch.float32, device="cpu", **kw)


# ---------------------------------------------------------------------------
# slot coupling
# ---------------------------------------------------------------------------


def _coupled_streams(pkg, n_requests, kv_page_size):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, int(n)) for n in rng.integers(5, 30, 12)]
    eng = _engine(pkg, max_slots=12, max_seq=64, kv_page_size=kv_page_size)
    mod = jserving if pkg == "jax" else tserving
    reqs = [eng.core.submit(p, mod.SamplingParams(max_new_tokens=16), arrival_time=0.0)
            for p in prompts[:n_requests]]
    while eng.core.has_unfinished:
        eng.core.step()
    return [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("kv_page_size", [None, 0], ids=["paged", "dense"])
def test_stream_depends_on_batch_mates_as_in_reference(kv_page_size):
    alone = {pkg: _coupled_streams(pkg, 1, kv_page_size) for pkg in ("jax", "torch")}
    full = {pkg: _coupled_streams(pkg, 12, kv_page_size) for pkg in ("jax", "torch")}
    assert alone["torch"] == alone["jax"]
    assert full["torch"] == full["jax"]
    # the first request's stream changes with the 11 requests beside it
    assert full["jax"][0] != alone["jax"][0]
    assert full["jax"][0][:2] == alone["jax"][0][:2]  # prefill is per row


# ---------------------------------------------------------------------------
# SpecInFRuntime
# ---------------------------------------------------------------------------

TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20,
                compute_dtype="float32")
SEQ, BATCH, ITERS = 16, 2, 3


def _jax_train(jtcfg):
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            return JT.lm_loss(JCFG, p, batch["inputs"], batch["labels"],
                              impl="xla", compute_dtype=jnp.float32)

        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g, gnorm = jclip(jax.tree.map(lambda x: x.astype(jnp.float32), g),
                         jtcfg.grad_clip_norm)
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"],
                                       lr=sched(state["opt"]["step"]), cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, "moe_aux": m["moe_aux"]}

    params = jax.tree.map(jnp.asarray, NP_PARAMS)
    ds = JDataset(JCFG, seq_len=SEQ, global_batch=BATCH, seed=1)
    batches = ({k: jnp.asarray(v) for k, v in ds.next_batch().items()}
               for _ in iter(int, 1))
    return step, {"params": params, "opt": jadamw_init(params)}, batches


def _torch_train():
    step = make_train_step(CFG, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(NP_PARAMS, device="cpu"))
    ds = SyntheticDataset(CFG, seq_len=SEQ, global_batch=BATCH, seed=1)
    return step, state, (ds.next_batch() for _ in iter(int, 1))


def _requests():
    rng = np.random.default_rng(3)
    offline = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (8, 40)]
    online = [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), 0.02 * i)
              for i, n in enumerate((5, 12, 33))]
    return offline, online


def _runtime(pkg):
    offline, online = _requests()
    engine = _engine(pkg, max_slots=3, max_seq=64)
    if pkg == "jax":
        step, state, batches = _jax_train(JTrainConfig(**TRAIN_KW))
        serving, core, Request = jserving, jcore, JRequest
        profile = jprofiles.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        cfg = JSpecInFConfig()
    else:
        step, state, batches = _torch_train()
        serving, core, Request = tserving, tcore, TRequest
        profile = tcore.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        cfg = SpecInFConfig()
    for p in offline:
        engine.core.submit(p, serving.SamplingParams(max_new_tokens=20),
                           priority=serving.Priority.OFFLINE)
    reqs = [Request(prompt=p, max_new_tokens=4, arrival_time=t, online=True)
            for p, t in online]
    auxes = []

    def train_step(s, b):
        s, metrics = step(s, b)
        auxes.append(float(metrics["moe_aux"]))
        return s, metrics

    rt = core.SpecInFRuntime(
        train_step=train_step, train_state=state, batch_iter=batches, profile=profile,
        engine=engine, online_requests=reqs, cfg=cfg, decode_microstep_s=0.004,
    )
    m = rt.run(ITERS)
    return {
        "losses": m.train_losses,
        "moe_aux": auxes,
        "phases": dict(m.phase_counts),
        "offline_microsteps": m.offline_microsteps,
        "offline_tokens": m.offline_tokens_generated,
        "online_served": m.online_served,
        "streams": [(cr.priority.value, list(cr.output_tokens), cr.state.value,
                     cr.preemptions) for _, cr in sorted(rt.core.requests.items())],
    }


def _plain_streams():
    """The same requests through a plain EngineCore, no runtime."""
    offline, online = _requests()
    engine = _engine("torch", max_slots=3, max_seq=64)
    reqs = [engine.core.submit(p, tserving.SamplingParams(max_new_tokens=20),
                               priority=tserving.Priority.OFFLINE) for p in offline]
    reqs += [engine.core.submit(p, tserving.SamplingParams(max_new_tokens=4),
                                priority=tserving.Priority.ONLINE) for p, _ in online]
    while engine.core.has_unfinished:
        engine.core.step()
    return [list(r.output_tokens) for r in reqs]


def test_runtime_matches_reference_and_plain_core():
    j, t = _runtime("jax"), _runtime("torch")
    assert t["phases"] == j["phases"]
    for key in ("offline_microsteps", "offline_tokens", "online_served", "streams"):
        assert t[key] == j[key], key
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    np.testing.assert_allclose(t["moe_aux"], j["moe_aux"], rtol=1e-5)
    assert len(t["losses"]) == ITERS and all(a > 0 for a in t["moe_aux"])
    assert t["offline_tokens"] > 0 and t["online_served"] > 0
    plain = _plain_streams()
    done = [(i, s) for i, (_, s, state, pre) in enumerate(t["streams"])
            if state == "finished_length" and pre == 0]
    assert done
    for i, s in done:
        assert s == plain[i], i

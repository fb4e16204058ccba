"""Port's engine and runtime serving the audio (musicgen-large) and VLM
(pixtral-12b) families against the reference, on the CPU in fp32.

At each arch's smoke config with the reference's weights (and
``draft_config``'s draft's) through ``bridge.params_from_numpy``, the same
submissions go through ``EngineCore`` on the paged layout with chunked
prefill and on the dense layout with monolithic prefill, plain and paired
with the draft model (``proposer="draft"``): an ONLINE arrival preempts an
OFFLINE request, and token budgets keep slots PREFILLING across quanta.
Token streams, finish reasons, every step's outputs and the counters must
equal the reference's exactly (greedy, fp32).  A monolithic admission
feeds the stub frontend's embeddings (``_embed_or_pass``: the bucket's rows
of the embedding table) to target and draft alike, and the chunked path
token ids.  A 3-iteration ``SpecInFRuntime`` run with a trainer on the stub
frontend's embedding batches and a token-serving engine gives the
reference's phase counts, streams and losses (rtol 1e-5), and
``measure_dp_profile`` probes that trainer and engine."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import SpecInFConfig as JSpecInFConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import draft_config as jdraft_config
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
from repro_torch.configs import SpecDecodeConfig, SpecInFConfig, TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

ARCHS = ("musicgen-large", "pixtral-12b")
LAYOUTS = {"paged-chunked": {}, "dense-monolithic": dict(kv_page_size=0, prefill_chunk=0)}
MAX_SLOTS, MAX_SEQ = 2, 96
COUNTERS = ("engine/prefill_prompt_tokens", "engine/prefill_metered_tokens",
            "engine/generated_tokens", "engine/d2h_transfers", "engine/steps_executed",
            "engine/spec_rounds", "engine/spec_drafted", "engine/spec_accepted",
            "core/preemptions")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _setup(arch):
    """Reference and port configs, the target's and the draft's weights as
    numpy (the reference's init), once per arch and worker."""
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jdcfg, dcfg = jdraft_config(jcfg), configs.draft_config(cfg)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    np_dparams = jax.tree.map(np.array, JT.init_params(jdcfg, jax.random.PRNGKey(1)))
    return (jcfg, cfg, jdcfg, dcfg, np_params, np_dparams)


class Clock:
    """Virtual clock advanced by the test between steps only."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(pkg, arch, layout, draft, clock):
    jcfg, cfg, jdcfg, dcfg, np_params, np_dparams = _setup(arch)
    kw = dict(clock=clock, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, **LAYOUTS[layout])
    if pkg == "jax":
        if draft:
            kw.update(spec=JSpecDecodeConfig(proposer="draft"), draft_cfg=jdcfg,
                      draft_params=jax.tree.map(jnp.asarray, np_dparams))
        return JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), compute_dtype=jnp.float32,
                       **kw), jserving
    if draft:
        kw.update(spec=SpecDecodeConfig(proposer="draft"), draft_cfg=dcfg,
                  draft_params=params_from_numpy(np_dparams, device="cpu"))
    return TEngine(cfg, params_from_numpy(np_params, device="cpu"),
                   compute_dtype=torch.float32, device="cpu", **kw), tserving


def _serve(pkg, arch, layout, draft):
    """The scenario; returns every step's outputs, the streams and the
    counters."""
    clock = Clock()
    eng, mod = _engine(pkg, arch, layout, draft, clock)
    core = eng.core
    rng = np.random.default_rng(0)
    vocab = configs.smoke_config(arch).vocab_size
    prompts = [rng.integers(0, vocab, n) for n in (46, 40, 20, 9)]
    order = {}

    def submit(prompt, n, priority):
        cr = core.submit(prompt, mod.SamplingParams(max_new_tokens=n), priority=priority,
                         arrival_time=clock.t)
        order[cr.request_id] = len(order)
        return cr

    off, on = mod.Priority.OFFLINE, mod.Priority.ONLINE
    reqs = [submit(prompts[0], 14, off), submit(prompts[1], 12, off)]
    steps = []
    for n in range(80):
        if n == 1:
            reqs.append(submit(prompts[2], 6, on))
        if n == 3:
            reqs.append(submit(prompts[3], 5, off))
        out = core.step(mod.Grant(token_budget=40 if n < 2 else float("inf")))
        steps.append((
            [order[i] for i in out.admitted], [order[i] for i in out.preempted],
            [order[cr.request_id] for cr in out.finished], out.k, out.gamma,
            out.prefill_tokens, out.cost_steps,
            sorted((order[o.request_id], tuple(o.new_tokens), o.state.value, o.finish_reason,
                    o.ttft_s) for o in out.outputs),
        ))
        clock.t += 0.01
        if n >= 3 and not core.has_unfinished:
            break
    assert not core.has_unfinished
    m = eng.obs.metrics
    return (steps, [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs],
            {name: m.counter(name).value for name in COUNTERS})


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_core_matches_reference(arch, layout, draft):
    """Streams, every step's outputs and the counters equal the reference's
    on both layouts, plain and draft-paired."""
    jsteps, jstreams, jcounters = _serve("jax", arch, layout, draft)
    tsteps, tstreams, tcounters = _serve("torch", arch, layout, draft)
    assert tstreams == jstreams
    assert tsteps == jsteps
    assert tcounters == jcounters
    assert all(reason == "length" for _, reason, _ in tstreams)
    assert any(p for _, _, p in tstreams)  # a preempted request resumed
    if draft:
        assert tcounters["engine/spec_rounds"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_monolithic_prefill_feeds_embeddings_chunked_feeds_tokens(arch, monkeypatch):
    """A monolithic admission hands target and draft ``prefill_into_slot``
    fp32 rows of their own embedding tables (the stub frontend); the paged
    layout's monolithic cold path does the same through
    ``prefill_into_slot_paged``; chunked prefill streams int32 token ids.
    Each monolithic admission launches the attention core once a layer."""
    _, cfg, _, dcfg, np_params, np_dparams = _setup(arch)
    seen = []
    for name in ("prefill_into_slot", "prefill_into_slot_paged", "prefill_chunks_into_slots"):
        real = getattr(T, name)

        def spy(c, params, inputs, *a, _real=real, _name=name, **kw):
            seen.append((_name, c.name, inputs.dtype, tuple(inputs.shape)))
            return _real(c, params, inputs, *a, **kw)

        monkeypatch.setattr(T, name, spy)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 21)
    for layout in ({"kv_page_size": 0, "prefill_chunk": 0}, {"prefill_chunk": 0}, {}):
        eng = TEngine(cfg, params_from_numpy(np_params, device="cpu"),
                      compute_dtype=torch.float32, device="cpu", max_slots=1, max_seq=64,
                      spec=SpecDecodeConfig(proposer="draft"), draft_cfg=dcfg,
                      draft_params=params_from_numpy(np_dparams, device="cpu"), **layout)
        seen.clear()
        ops.reset_launch_counts()
        r = eng.core.submit(prompt, tserving.SamplingParams(max_new_tokens=2))
        eng.core.step()
        while eng.core.has_unfinished:
            eng.core.step()
        assert len(r.output_tokens) == 2
        if layout == {}:
            assert {s[0] for s in seen} == {"prefill_chunks_into_slots"}
            assert all(s[2] == torch.int32 for s in seen)
            continue
        target = "prefill_into_slot" if layout.get("kv_page_size") == 0 else (
            "prefill_into_slot_paged")
        assert [(s[0], s[1]) for s in seen] == [(target, cfg.name),
                                                ("prefill_into_slot", dcfg.name)]
        assert all(s[2] == torch.float32 and len(s[3]) == 3 for s in seen)
        assert [s[3][2] for s in seen] == [cfg.d_model, dcfg.d_model]
        flash = ops.launch_counts()["flash_attention_fwd"]
        assert flash == {"cuda": 0, "torch": cfg.num_layers + dcfg.num_layers}


# ---------------------------------------------------------------------------
# SpecInFRuntime over a stub-frontend trainer and a token-serving engine
# ---------------------------------------------------------------------------

RUNTIME_ARCH = "musicgen-large"
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20, compute_dtype="float32")
SEQ, BATCH, ITERS = 16, 2, 3


def _runtime(pkg):
    jcfg, cfg, _, _, np_params, _ = _setup(RUNTIME_ARCH)
    rng = np.random.default_rng(3)
    offline = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 40)]
    online = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 0.02 * i)
              for i, n in enumerate((5, 12, 33))]
    if pkg == "jax":
        jtcfg = JTrainConfig(**TRAIN_KW)
        sched = jmake_schedule(jtcfg)

        @jax.jit
        def step(state, batch):
            def loss_fn(p):
                return JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"], impl="xla",
                                  compute_dtype=jnp.float32)

            (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
            g, gnorm = jclip(jax.tree.map(lambda x: x.astype(jnp.float32), g),
                             jtcfg.grad_clip_norm)
            new_p, new_opt = jadamw_update(g, state["opt"], state["params"],
                                           lr=sched(state["opt"]["step"]), cfg=jtcfg)
            return {"params": new_p, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

        params = jax.tree.map(jnp.asarray, np_params)
        state = {"params": params, "opt": jadamw_init(params)}
        ds = JDataset(jcfg, seq_len=SEQ, global_batch=BATCH, seed=1)
        batches = ({k: jnp.asarray(v) for k, v in ds.next_batch().items()}
                   for _ in iter(int, 1))
        engine = JEngine(jcfg, params, max_slots=3, max_seq=64, compute_dtype=jnp.float32)
        serving, core, Request = jserving, jcore, JRequest
        profile = jprofiles.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        scfg = JSpecInFConfig()
    else:
        step = make_train_step(cfg, TrainConfig(**TRAIN_KW), device="cpu")
        state = init_train_state(params_from_numpy(np_params, device="cpu"))
        ds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=BATCH, seed=1)
        batches = (ds.next_batch() for _ in iter(int, 1))
        engine = TEngine(cfg, params_from_numpy(np_params, device="cpu"), max_slots=3,
                         max_seq=64, compute_dtype=torch.float32, device="cpu")
        serving, core, Request = tserving, tcore, TRequest
        profile = tcore.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        scfg = SpecInFConfig()
    for p in offline:
        engine.core.submit(p, serving.SamplingParams(max_new_tokens=20),
                           priority=serving.Priority.OFFLINE)
    reqs = [Request(prompt=p, max_new_tokens=4, arrival_time=t, online=True)
            for p, t in online]
    rt = core.SpecInFRuntime(train_step=step, train_state=state, batch_iter=batches,
                             profile=profile, engine=engine, online_requests=reqs, cfg=scfg,
                             decode_microstep_s=0.004)
    m = rt.run(ITERS)
    streams = [(cr.priority.value, list(cr.output_tokens), cr.state.value)
               for _, cr in sorted(rt.core.requests.items())]
    return m, streams


def test_runtime_with_an_embedding_trainer_matches_reference():
    """The runtime's train iterator hands the stub frontend's fp32 batches
    to the trainer while its engine serves token prompts: phase counts,
    filled work, streams and losses equal the reference's."""
    jm, jstreams = _runtime("jax")
    tm, tstreams = _runtime("torch")
    assert dict(tm.phase_counts) == dict(jm.phase_counts)
    for key in ("offline_microsteps", "offline_tokens_generated", "online_served"):
        assert getattr(tm, key) == getattr(jm, key), key
    assert tm.offline_tokens_generated > 0 and tm.online_served > 0
    assert tstreams == jstreams
    assert len(tm.train_losses) == ITERS
    np.testing.assert_allclose(tm.train_losses, jm.train_losses, rtol=1e-5)


def test_dp_profile_probe_on_an_embedding_trainer():
    """``measure_dp_profile`` times the stub-frontend trainer's step and the
    token-serving engine's microstep; the probe leaves the core empty."""
    _, cfg, _, _, np_params, _ = _setup(RUNTIME_ARCH)
    step = make_train_step(cfg, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(np_params, device="cpu"))
    ds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=BATCH, seed=1)
    engine = TEngine(cfg, params_from_numpy(np_params, device="cpu"), max_slots=4,
                     max_seq=64, compute_dtype=torch.float32, device="cpu")
    profile, micro_s = tcore.measure_dp_profile("musicgen-smoke", step, state,
                                                (ds.next_batch() for _ in iter(int, 1)),
                                                engine)
    assert profile.compute_s > 0 and micro_s > 0
    assert not engine.core.has_unfinished
    assert int(state["opt"]["step"]) == 2

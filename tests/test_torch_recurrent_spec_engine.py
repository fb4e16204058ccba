"""Port's speculating engine with a recurrent target and draft (Mamba1:
falcon-mamba-7b; the Zamba2 hybrid: zamba2-2.7b) against the reference, on
the CPU in fp32.

* ``EngineCore`` runs (the draft model from ``draft_config``, ``proposer``
  "auto", an ONLINE arrival preempting an OFFLINE request): every step's
  outputs and the streams equal the reference engine's and the plain
  greedy engine's, with rollback exercised (drafted > accepted); "auto"
  routes to the draft alone (host proposers need an attention target).
  The mixed pairings: ``tests/test_torch_recurrent_spec_pairings.py``.

Tokens, steps and counters exact (greedy, fp32).  Weights come from the
reference's init through ``bridge.params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import draft_config as jdraft_config
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig, draft_config
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jdcfg, dcfg = jdraft_config(jcfg), draft_config(cfg)
    params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    dparams = jax.tree.map(np.array, JT.init_params(jdcfg, jax.random.PRNGKey(7)))
    return jcfg, cfg, jdcfg, dcfg, params, dparams


class Clock:
    """Virtual clock advanced by the test between steps only."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(pkg, cfgs, params, proposer, clock, **kw):
    """An engine of either package over ``cfgs`` = (target, draft or None)
    configs (the reference's for "jax") and numpy weights."""
    (cfg, dcfg), (np_params, np_dparams) = cfgs, params
    if pkg == "jax":
        spec = {} if proposer is None else {"spec": JSpecDecodeConfig(proposer=proposer)}
        if dcfg is not None:
            spec.update(draft_cfg=dcfg, draft_params=jax.tree.map(jnp.asarray, np_dparams))
        return JEngine(cfg, jax.tree.map(jnp.asarray, np_params), compute_dtype=jnp.float32,
                       clock=clock, **spec, **kw)
    spec = {} if proposer is None else {"spec": SpecDecodeConfig(proposer=proposer)}
    if dcfg is not None:
        spec.update(draft_cfg=dcfg, draft_params=params_from_numpy(np_dparams, device="cpu"))
    return TEngine(cfg, params_from_numpy(np_params, device="cpu"), compute_dtype=torch.float32,
                   clock=clock, device="cpu", **spec, **kw)


def _serve(pkg, cfgs, params, proposer, **kw):
    """Three requests through EngineCore on 2 slots (an ONLINE arrival
    preempts an OFFLINE one); returns every step's outputs, the streams and
    the speculation counters."""
    clock = Clock()
    eng = _engine(pkg, cfgs, params, proposer, clock, max_slots=2, max_seq=64, **kw)
    mod = jserving if pkg == "jax" else tserving
    core = eng.core
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfgs[0].vocab_size, n) for n in (21, 13, 6)]
    order = {}

    def submit(prompt, n, priority):
        cr = core.submit(prompt, mod.SamplingParams(max_new_tokens=n), priority=priority,
                         arrival_time=clock.t)
        order[cr.request_id] = len(order)
        return cr

    off, on = mod.Priority.OFFLINE, mod.Priority.ONLINE
    reqs = [submit(prompts[0], 14, off), submit(prompts[1], 11, off)]
    steps = []
    for n in range(60):
        if n == 1:
            reqs.append(submit(prompts[2], 6, on))
        out = core.step()
        steps.append((
            [order[i] for i in out.admitted], [order[i] for i in out.preempted],
            [order[cr.request_id] for cr in out.finished], out.k, out.gamma, out.proposer,
            out.spec_accepted, out.spec_proposed,
            sorted((order[o.request_id], tuple(o.new_tokens), o.state.value, o.finish_reason)
                   for o in out.outputs),
        ))
        clock.t += 0.01
        if not core.has_unfinished:
            break
    assert not core.has_unfinished
    counts = (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted)
    return steps, [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs], counts


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference_and_plain_greedy(arch):
    jcfg, cfg, jdcfg, dcfg, np_params, np_dparams = _setup(arch)
    ps = (np_params, np_dparams)
    jsteps, jstreams, jcounts = _serve("jax", (jcfg, jdcfg), ps, "auto")
    tsteps, tstreams, tcounts = _serve("torch", (cfg, dcfg), ps, "auto")
    _, plain, _ = _serve("torch", (cfg, None), ps, None)
    assert tstreams == jstreams
    assert tsteps == jsteps
    assert tcounts == jcounts
    assert [s for s, _, _ in tstreams] == [s for s, _, _ in plain]
    assert all(reason == "length" for _, reason, _ in tstreams)
    assert any(p for _, _, p in tstreams)  # a preempted request resumed
    rounds, drafted, accepted = tcounts
    assert rounds > 0 and drafted > accepted  # rollback exercised
    assert {s[5] for s in tsteps if s[4] is not None} == {"draft"}  # no host proposer

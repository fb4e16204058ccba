"""The two dense configs this slice adds (qwen2-7b: QKV bias, GQA group 7;
deepseek-coder-33b: GQA group 7), on their smoke configs in fp32 on the
CPU: ``forward`` against the reference's logits (atol 1e-5), and one
``EngineCore`` run on the paged layout with chunked prefill, whose token
streams equal the reference engine's on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine

ARCHS = ("qwen2-7b", "deepseek-coder-33b")


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
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(2)))
    return jcfg, cfg, np_params


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, cfg, np_params = _setup(arch)
    inputs = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    jlogits, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(inputs), impl="xla", compute_dtype=jnp.float32)
    logits, metrics = T.forward(cfg, params_from_numpy(np_params, device="cpu"),
                                torch.from_numpy(inputs), compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert float(metrics["moe_aux"]) == 0.0
    if arch == "qwen2-7b":
        assert "bq" in np_params["layers"]["attn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch):
    jcfg, cfg, np_params = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 9, 27, 50)]
    kw = dict(max_slots=2, max_seq=96, clock=lambda: 0.0)
    engines = {
        "jax": (JEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                        compute_dtype=jnp.float32, **kw), jserving),
        "torch": (TEngine(cfg, params_from_numpy(np_params, device="cpu"),
                          compute_dtype=torch.float32, device="cpu", **kw), tserving),
    }
    streams = {}
    for pkg, (eng, mod) in engines.items():
        reqs = [eng.core.submit(p, mod.SamplingParams(max_new_tokens=10), arrival_time=0.0)
                for p in prompts]
        while eng.core.has_unfinished:
            eng.core.step()
        streams[pkg] = [list(r.output_tokens) for r in reqs]
    assert streams["torch"] == streams["jax"]
    assert all(len(s) == 10 for s in streams["torch"])

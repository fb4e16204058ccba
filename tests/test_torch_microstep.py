"""``InferenceEngine.decode_microstep`` against the reference's, on the CPU in
fp32.

Three requests are admitted into a 3-slot engine (the reference's
``_admit_request(stream_prefill=True)``); one chunk wave completes two
prompts and leaves the third PREFILLING, three microsteps run with it
still PREFILLING (its index must come back to its prefill progress), its
last chunks stream, and microsteps run until every request has finished.
For qwen3-smoke and moonshot-smoke on the paged and the dense layout, the
port's generated tokens, finish order, ``d2h_transfers`` (one a
microstep), ``steps_executed`` and cache indices equal the reference's, and
the same schedule with the fused loop (``_drive_decode_loop(1)``) in place
of each microstep gives the same tokens and transfers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

PROMPT_LENS, MAX_NEW = (20, 24, 80), (6, 9, 5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(pkg, arch, kv_page_size, step="microstep"):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    kw = dict(max_slots=3, max_seq=96, kv_page_size=kv_page_size, clock=lambda: 0.0)
    if pkg == "jax":
        eng = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                      compute_dtype=jnp.float32, **kw)
        admit = lambda r: eng._admit_request(r, stream_prefill=True)
        Request = JRequest
    else:
        eng = TEngine(cfg, params_from_numpy(np_params, device="cpu"),
                      compute_dtype=torch.float32, device="cpu", **kw)
        admit = eng._admit_request
        Request = TRequest
    decode = eng.decode_microstep if step == "microstep" else (
        lambda: eng._drive_decode_loop(1))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(PROMPT_LENS, MAX_NEW)]
    order = {r.request_id: i for i, r in enumerate(reqs)}
    for r in reqs:
        assert admit(r)
    eng._drive_prefill_chunks(20 + 24 + 32)  # the 80-token prompt stays PREFILLING
    assert eng.num_prefilling == 1
    finished, indices = [], []
    for _ in range(3):
        finished += [order[r.request_id] for r in decode()]
        indices.append(np.asarray(eng.cache["index"]).tolist())
    assert eng.num_prefilling == 1
    eng._drive_prefill_chunks()
    for _ in range(20):
        if eng.num_active == 0:
            break
        finished += [order[r.request_id] for r in decode()]
        indices.append(np.asarray(eng.cache["index"]).tolist())
    assert eng.num_active == 0
    return {
        "generated": [list(map(int, r.generated)) for r in reqs],
        "finished": finished,
        "d2h": eng.d2h_transfers,
        "steps": eng.steps_executed,
        "indices": indices,
    }


@pytest.mark.parametrize("kv_page_size", [None, 0], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b"])
def test_decode_microstep_matches_reference_and_fused_loop(arch, kv_page_size):
    ref = _run("jax", arch, kv_page_size)
    got = _run("torch", arch, kv_page_size)
    assert got == ref
    assert [len(g) for g in got["generated"]] == list(MAX_NEW)
    assert sorted(got["finished"]) == [0, 1, 2]
    # the PREFILLING slot's index is its prefill progress after each step
    assert [i[2] for i in got["indices"][:3]] == [32, 32, 32]
    fused = _run("torch", arch, kv_page_size, step="fused")
    assert fused["generated"] == got["generated"]
    assert fused["d2h"] == got["d2h"]

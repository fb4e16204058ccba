"""Port model steps against ``repro.models.transformer`` on the same weights
(the reference's init, bridged with ``params_from_numpy``) and the same paged
cache, qwen3-1.7b smoke config in fp32: chunked prefill into slots (ragged
chunk lengths, a frozen slot, a second wave with ``starts > 0``), one decode
step, and the fused decode loop with per-slot freeze.  Logits agree to atol
1e-4 (fp32 through 2 layers, sums in another order); tokens are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as T

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
B, PAGE, PER_SLOT, CHUNK = 3, 16, 4, 32
LOGITS_ATOL = 1e-4
KV_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _caches():
    num_pages = B * PER_SLOT + 1
    rng = np.random.default_rng(0)
    bt = np.zeros((B, PER_SLOT + 1), np.int32)
    bt[:, :PER_SLOT] = rng.permutation(np.arange(1, num_pages)).reshape(B, PER_SLOT)
    jc = JT.init_paged_cache(JCFG, B, num_pages, PAGE, PER_SLOT, jnp.float32)
    jc["block_tables"] = jnp.asarray(bt)
    tc = T.init_paged_cache(CFG, B, num_pages, PAGE, PER_SLOT, torch.float32, "cpu")
    tc["block_tables"] = torch.tensor(bt)
    return jc, tc


def _prefill(jc, tc, toks, lens):
    jtok, jc = JT.prefill_chunks_into_slots(
        JCFG, JPARAMS, jnp.asarray(toks), jnp.asarray(lens), jc,
        compute_dtype=jnp.float32,
    )
    ttok, tc = T.prefill_chunks_into_slots(
        CFG, PARAMS, torch.tensor(toks), torch.tensor(lens), tc,
        compute_dtype=torch.float32,
    )
    return jtok, jc, ttok, tc


def _assert_cache_close(jc, tc):
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    for name in ("k", "v"):
        ref = np.asarray(jc["layers"][name])
        got = tc["layers"][name].numpy()
        # the sentinel page 0 takes colliding pad writes (winner unspecified)
        np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=KV_ATOL)


def _prefilled():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (40, 20, 33)]
    jc, tc = _caches()
    toks1 = np.zeros((B, CHUNK), np.int32)
    lens1 = np.asarray([32, 20, 0], np.int32)  # slot 2 frozen in wave 1
    toks1[0], toks1[1, :20] = prompts[0][:32], prompts[1]
    jtok, jc, ttok, tc = _prefill(jc, tc, toks1, lens1)
    np.testing.assert_array_equal(ttok.numpy()[:2], np.asarray(jtok)[:2])
    toks2 = np.zeros((B, CHUNK), np.int32)
    lens2 = np.asarray([8, 0, 32], np.int32)  # slot 0 resumes at start 32
    toks2[0, :8], toks2[2] = prompts[0][32:], prompts[2][:32]
    jtok2, jc, ttok2, tc = _prefill(jc, tc, toks2, lens2)
    np.testing.assert_array_equal(ttok2.numpy()[[0, 2]], np.asarray(jtok2)[[0, 2]])
    _assert_cache_close(jc, tc)
    first = np.asarray([jtok2[0], jtok[1], jtok2[2]], np.int32)
    return jc, tc, first


def test_prefill_chunks_into_slots_matches_reference():
    _prefilled()


def test_decode_step_matches_reference():
    jc, tc, first = _prefilled()
    jlogits, jc = JT.decode_step(
        JCFG, JPARAMS, jnp.asarray(first), jc, compute_dtype=jnp.float32
    )
    tlogits, tc = T.decode_step(
        CFG, PARAMS, torch.tensor(first), tc, compute_dtype=torch.float32
    )
    np.testing.assert_allclose(
        tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGITS_ATOL
    )
    np.testing.assert_array_equal(
        tlogits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1)
    )
    _assert_cache_close(jc, tc)


def test_decode_loop_matches_reference_with_per_slot_freeze():
    jc, tc, first = _prefilled()
    remaining = np.asarray([6, 2, 0], np.int32)  # slot 2 stays frozen
    jout = JT.decode_loop(
        JCFG, JPARAMS, jnp.asarray(first), jc, jnp.asarray(remaining),
        k=4, max_seq=PER_SLOT * PAGE, compute_dtype=jnp.float32,
    )
    tout = T.decode_loop(
        CFG, PARAMS, torch.tensor(first), tc, torch.tensor(remaining),
        k=4, max_seq=PER_SLOT * PAGE, compute_dtype=torch.float32,
    )
    (jtok, jc, jrem, jseq, jsteps, jbad) = jout
    (ttok, tc, trem, tseq, tsteps, tbad) = tout
    for got, ref in ((ttok, jtok), (trem, jrem), (tseq, jseq), (tsteps, jsteps),
                     (tbad, jbad)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tsteps.numpy(), [4, 2, 0])
    _assert_cache_close(jc, tc)

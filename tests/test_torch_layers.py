"""Port layers against ``repro.models.layers``: norms, RoPE, head mask, the
q/k/v projection (qk-norm before RoPE), the paged KV write (sentinel clamp
included) and the MLP, on the qwen3-1.7b smoke config in fp32.  Inputs and
weights come from numpy seeds / the reference's init and go to both
packages.  Tolerance atol 1e-5 (fp32, sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL = 1e-5
JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
LAYER0 = jax.tree.map(lambda a: a[0].copy(), NP_PARAMS["layers"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port, ref):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL
    )


def test_smoke_config_matches_reference():
    """The port's ``ModelConfig`` has every field of the reference's (the
    frontend's ``embed_inputs`` returned with the audio and VLM families),
    and each equals the reference's, for every arch the port registers, full
    and smoke size."""
    assert {f.name for f in dataclasses.fields(type(CFG))} == {
        f.name for f in dataclasses.fields(type(JCFG))
    }
    pairs = [(CFG, JCFG)]
    for arch in configs.ARCH_IDS:
        pairs.append((configs.get_config(arch), jconfigs.get_config(arch)))
        pairs.append((configs.smoke_config(arch), jconfigs.smoke_config(arch)))
    for port, ref in pairs:
        assert (port.resolved_dt_rank, port.d_inner) == (ref.resolved_dt_rank, ref.d_inner)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_init_params_tree_shapes_and_scales_match_reference():
    port = T.init_params(CFG, torch.Generator().manual_seed(0))
    ref = jax.tree_util.tree_flatten_with_path(NP_PARAMS)[0]
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v

    walk(port, ())
    assert len(flat) == len(ref)
    for path, arr in ref:
        key = tuple(p.key for p in path)
        t = flat[key]
        assert tuple(t.shape) == arr.shape, key
        # same init scale: std within 25% (different generators)
        if arr.std() > 0:
            assert abs(t.std().item() / arr.std() - 1) < 0.25, key
        else:
            assert torch.equal(t, torch.from_numpy(arr)), key


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    port_fn, ref_fn = (L.rms_norm, JL.rms_norm) if norm == "rms" else (
        L.layer_norm, JL.layer_norm)
    _close(port_fn(torch.from_numpy(x), torch.from_numpy(w)),
           ref_fn(jnp.asarray(x), jnp.asarray(w)))
    _close(port_fn(torch.from_numpy(x), None), ref_fn(jnp.asarray(x), None))


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 6)).astype(np.int32)
    _close(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), CFG.rope_theta),
        JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), JCFG.rope_theta),
    )


def test_head_mask_padded_and_unpadded():
    assert L.head_mask(CFG, torch.float32, "cpu") is None
    pcfg = dataclasses.replace(CFG, pad_heads_to=6)
    jpcfg = dataclasses.replace(JCFG, pad_heads_to=6)
    _close(L.head_mask(pcfg, torch.float32, "cpu"),
           JL.head_mask(jpcfg, jnp.float32))


def test_project_qkv_qk_norm_before_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5)).astype(np.int32)
    attn = {k: torch.from_numpy(v) for k, v in LAYER0["attn"].items()}
    # non-trivial qk-norm weights, so the norm's placement matters
    attn["q_norm"] = torch.linspace(0.5, 1.5, CFG.resolved_head_dim)
    attn["k_norm"] = torch.linspace(1.5, 0.5, CFG.resolved_head_dim)
    jattn = {k: jnp.asarray(v.numpy()) for k, v in attn.items()}
    port = L._project_qkv(CFG, attn, torch.from_numpy(x), torch.from_numpy(pos))
    ref = JL._project_qkv(JCFG, jattn, jnp.asarray(x), jnp.asarray(pos))
    for p, r in zip(port, ref):
        _close(p, r)


def test_paged_kv_write_with_sentinel_clamp():
    rng = np.random.default_rng(3)
    page, kvh, hd, w = 4, 2, 8, 3  # 2 real columns + sentinel
    pool = rng.standard_normal((7, page, kvh, hd)).astype(np.float32)
    new = rng.standard_normal((2, 5, kvh, hd)).astype(np.float32)
    bt = np.asarray([[3, 5, 0], [6, 1, 0]], np.int32)
    # row 0: positions inside its 2 pages; row 1: overflow past W-1 pages
    # (including the chunk-pad position W * page) clamps onto the sentinel
    positions = np.asarray([[0, 3, 4, 6, 7], [6, 7, 8, 11, w * page]], np.int32)
    (port,) = L.paged_kv_write((torch.from_numpy(pool.copy()),), (torch.from_numpy(new),),
                               torch.from_numpy(bt), torch.from_numpy(positions))
    ref = np.asarray(JL.paged_kv_write(jnp.asarray(pool), jnp.asarray(new),
                                       jnp.asarray(bt), jnp.asarray(positions)))
    # the sentinel page takes several colliding writes: the port keeps the
    # last, as the reference's scatter does on the CPU, so every page matches
    np.testing.assert_array_equal(port.numpy(), ref)
    assert not np.array_equal(ref[3], pool[3])  # the write landed


def test_mlp_block():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    ffn = LAYER0["ffn"]
    _close(
        L.mlp_block({k: torch.from_numpy(v) for k, v in ffn.items()},
                    torch.from_numpy(x)),
        JL.mlp_block({k: jnp.asarray(v) for k, v in ffn.items()}, jnp.asarray(x)),
    )


def test_params_from_numpy_is_a_plain_copy():
    flat_ref = jax.tree.leaves(NP_PARAMS)
    flat = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else flat.append(v)

    walk(PARAMS)
    assert len(flat) == len(flat_ref)
    assert set(PARAMS) == set(NP_PARAMS)
    np.testing.assert_array_equal(PARAMS["layers"]["attn"]["wq"].numpy(),
                                  NP_PARAMS["layers"]["attn"]["wq"])

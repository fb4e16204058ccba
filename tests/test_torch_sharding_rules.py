"""Sharding-rule parity on shapes only: the port's ``runtime.sharding``
against the reference's, leaf for leaf, for all 10 archs.

Both sides read the reference's abstract trees (``abstract_params`` /
``abstract_cache``: ``ShapeDtypeStruct``s at full size, nothing allocated)
on the reference's symbolic 16x16 and 2x16x16 meshes (a ``FakeMesh``, as
``tests/test_sharding_rules.py`` has it), over the ``"tp"`` and
``"dp256"`` layouts, FSDP on and off and ZeRO-1 on and off:
``param_specs``, ``opt_state_specs``, ``cache_specs`` (decode_32k and
long_500k where applicable), ``batch_specs``, ``activation_specs`` (batch
sharded and not) and ``logits_spec``.  One more case runs the port's own
parameter tree (``runtime.abstract_params``: meta tensors) of three archs
through the port's rules and holds it to the reference's tree and specs.
"""
from __future__ import annotations

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.runtime import sharding as JS
from repro.runtime.step import abstract_cache, abstract_params as jabstract_params
from repro_torch import configs
from repro_torch.runtime import abstract_params
from repro_torch.runtime import sharding as S

ARCHS = list(jconfigs.ARCH_IDS)
LAYOUTS = ("tp", "dp256")


class FakeMesh:
    """Shape/axis-name stand-in (rule logic only reads these)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


#: (arch, decode shape) pairs the reference has a cache for
CACHE_CASES = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
               if jconfigs.shape_applicable(jconfigs.get_config(a), jconfigs.get_shape(s))[0]]
MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jabstract_params(jconfigs.get_config(arch))


def _flat_ref(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in leaves}


def _flat_port(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}{k}/"))
        return out
    assert isinstance(tree, S.P), (prefix, tree)
    return {prefix[:-1]: tuple(tree)}


def _same(port, ref):
    """Equal leaf for leaf (JAX flattens dict keys sorted, the port keeps
    insertion order: compared by path)."""
    assert _flat_port(port) == _flat_ref(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_reference(arch, mesh):
    jcfg, cfg, m = jconfigs.get_config(arch), configs.get_config(arch), MESHES[mesh]
    shapes = _ref_params(arch)
    for layout in LAYOUTS:
        for fsdp in (False, True):
            _same(S.param_specs(cfg, shapes, mesh=m, fsdp=fsdp, layout=layout),
                  JS.param_specs(jcfg, shapes, mesh=m, fsdp=fsdp, layout=layout))
            for zero1 in (False, True):
                _same(S.opt_state_specs(cfg, shapes, zero1, m, fsdp=fsdp, layout=layout),
                      JS.opt_state_specs(jcfg, shapes, zero1, m, fsdp=fsdp, layout=layout))
    for zero1 in (False, True):
        state = {"params": shapes}
        _same(S.state_specs(cfg, state, zero1=zero1, mesh=m, fsdp=True),
              JS.state_specs(jcfg, state, zero1=zero1, mesh=m, fsdp=True))


@pytest.mark.parametrize("arch,shape_name", CACHE_CASES)
def test_cache_specs_match_reference(arch, shape_name):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    shape = jconfigs.get_shape(shape_name)
    cache = abstract_cache(jcfg, shape.global_batch, shape.seq_len)
    for m in MESHES.values():
        _same(S.cache_specs(cfg, cache, configs.SHAPES[shape_name], m),
              JS.cache_specs(jcfg, cache, shape, m))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_activation_and_logits_specs_match_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for m in MESHES.values():
        assert tuple(S.logits_spec(cfg, m)) == tuple(JS.logits_spec(jcfg, m))
        for layout in LAYOUTS:
            assert S.dp_axes(m, layout) == JS.dp_axes(m, layout)
            _same(S.batch_specs(cfg, None, m, layout=layout),
                  JS.batch_specs(jcfg, None, m, layout=layout))
            for sharded in (True, False):
                _same(S.activation_specs(cfg, m, batch_sharded=sharded, layout=layout),
                      JS.activation_specs(jcfg, m, batch_sharded=sharded, layout=layout))


@pytest.mark.parametrize("arch", ["olmo-1b", "dbrx-132b", "zamba2-2.7b"])
def test_port_parameter_tree_gets_the_reference_specs(arch):
    """The port's own tree (meta tensors, nothing allocated; a dense tree
    with tied embeddings, 132 B MoE parameters, the hybrid's two stack
    dims): the reference's paths and shapes, and under the rules the
    reference's specs (16x16, dp256 and tp, FSDP and ZeRO-1)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    tree = abstract_params(cfg)
    ref = _ref_params(arch)
    flat = {p: tuple(t.shape) for p, t in _flat_leaves(tree)}
    assert flat == {"/".join(str(k.key) for k in path): tuple(x.shape)
                    for path, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert all(t.device.type == "meta" for _, t in _flat_leaves(tree))
    m = MESHES["single"]
    for layout in LAYOUTS:
        _same(S.opt_state_specs(cfg, tree, True, m, fsdp=True, layout=layout),
              JS.opt_state_specs(jcfg, ref, True, m, fsdp=True, layout=layout))


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_unknown_parameter_fails_loudly():
    import torch

    cfg = configs.get_config("olmo-1b")
    bogus = {"layers": {"mystery_weight": torch.empty((8, 8), device="meta")}}
    with pytest.raises(ValueError, match="no sharding rule"):
        S.param_specs(cfg, bogus, mesh=MESHES["single"])


def test_fsdp_places_the_joint_axes_under_dp256():
    """dp256 splits a big free dim over the product ("data", "model"),
    row major in the mesh's order (the rule ``shard_tensor`` follows)."""
    cfg = configs.get_config("deepseek-coder-33b")
    specs = S.param_specs(cfg, abstract_params(cfg), mesh=MESHES["single"], fsdp=True,
                          layout="dp256")
    assert ("data", "model") in tuple(specs["layers"]["ffn"]["wg"])
    assert "model" not in {e for spec in _flat_port(specs).values() for e in spec}

"""The port's config registry, shapes and paper_edge against the JAX
package's.

All ten architecture ids resolve in both, in the same order; every
``CONFIG`` and ``SMOKE`` equals the reference's field by field (the
kernel-selection fields aside, which name each package's own
implementations), with the same analytic ``n_params`` and
``active_params``. ``param_shapes`` of every config gives the shapes and
dtypes of the reference's ``jax.eval_shape`` of its init, allocating
nothing.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import paper_edge as jedge
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.models import transformer as jtf
from repro_torch.configs import paper_edge as tedge
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.models import transformer as ttf

IMPL_FIELDS = {"attn_impl", "ssm_impl"}
DENSE = ("command-r-35b", "phi4-mini-3.8b", "internlm2-1.8b",
         "qwen1.5-0.5b")
PORTED_FAMILIES = ("dense", "hybrid")


def fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in IMPL_FIELDS}


def test_registry_holds_all_ten_ids_in_order():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert len(treg.ARCH_IDS) == 10
    assert tuple(treg.all_configs()) == tuple(jreg.all_configs())
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-7")


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_matches_the_reference(arch, which):
    get_t = treg.get_config if which == "CONFIG" else treg.get_smoke_config
    get_j = jreg.get_config if which == "CONFIG" else jreg.get_smoke_config
    tcfg, jcfg = get_t(arch), get_j(arch)
    assert fields(tcfg) == fields(jcfg)
    assert tcfg.attn_impl == "kernel" and tcfg.ssm_impl == "kernel"
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.active_params() == jcfg.active_params()
    for prop in ("hd", "padded_vocab", "d_inner", "ssm_heads"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert str(tcfg.act_dtype).split(".")[-1] == jcfg.act_dtype.name
    assert str(tcfg.p_dtype).split(".")[-1] == jcfg.p_dtype.name


def test_moe_active_params_count_only_routed_experts():
    cfg = treg.get_config("phi3.5-moe-42b-a6.6b")
    d, ff = cfg.d_model, cfg.d_ff
    assert cfg.n_params() - cfg.active_params() == cfg.n_layers * (
        (cfg.n_experts - cfg.experts_per_token) * 3 * d * ff)
    dense = treg.get_config("internlm2-1.8b")
    assert dense.active_params() == dense.n_params()


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_shape_cells_match_the_reference(arch):
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert tshapes.cells(tcfg) == jshapes.cells(jcfg)
    for name in tshapes.SHAPES:
        assert tshapes.applicable(tcfg, name) == \
            jshapes.applicable(jcfg, name)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_match_eval_shape(arch, smoke):
    """Shapes and dtypes of every leaf, as ``jax.eval_shape`` gives them;
    the port's leaves live on the meta device (nothing allocated)."""
    get_t = treg.get_smoke_config if smoke else treg.get_config
    get_j = jreg.get_smoke_config if smoke else jreg.get_config
    got = dict(_flat(ttf.param_shapes(get_t(arch))))
    want = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jtf.param_shapes(get_j(arch)))[0]}
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert str(got[key].dtype).split(".")[-1] == leaf.dtype.name, key
        assert got[key].device.type == "meta", key
    total = sum(int(np.prod(leaf.shape)) for leaf in want.values())
    assert total == sum(t.numel() for t in got.values())


@pytest.mark.parametrize("arch", [a for a in jreg.ARCH_IDS
                                  if jreg.get_config(a).family
                                  not in PORTED_FAMILIES])
def test_unported_families_are_data_only(arch):
    """The families that were data only until the port served them (moe,
    vlm, audio, ssm; the name is the one this test had then) now build:
    ``param_spec`` and ``param_shapes`` at full and smoke size give the
    shapes and dtypes of the reference's ``jax.eval_shape``."""
    for smoke in (False, True):
        test_param_shapes_match_eval_shape(arch, smoke)


def _system(spec) -> dict:
    return {"eet": np.asarray(spec.eet, np.float32),
            "p_dyn": np.asarray(spec.p_dyn, np.float32),
            "p_idle": np.asarray(spec.p_idle, np.float32),
            "queue_size": spec.queue_size,
            "fairness_factor": spec.fairness_factor,
            "site_of_machine": spec.site_of_machine,
            "tier_of_site": spec.tier_of_site}


def test_paper_edge_matches_the_reference():
    for name in ("SYSTEM", "AWS"):
        got, want = _system(getattr(tedge, name)), \
            _system(getattr(jedge, name))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    assert tedge.SCENARIO.to_json_dict() == jedge.SCENARIO.to_json_dict()
    assert tedge.STRESS_SCENARIOS == jedge.STRESS_SCENARIOS
    assert "poisson" not in tedge.STRESS_SCENARIOS

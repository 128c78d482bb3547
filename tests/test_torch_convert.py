"""Configs and the weight bridge: every architecture's config equals the
JAX package's field for field, and JAX params converted to the port's
layout hold exactly cfg.param_count() elements."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ALL_ARCHS = list(jconfigs.ARCHS)
MODEL_ARCHS = jconfigs.list_archs()
SUPPORTED = ["smollm-135m", "codeqwen1.5-7b", "minitron-4b", "stablelm-3b",
             "grok-1-314b", "llama4-maverick-400b-a17b"]


def test_registry_matches():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_fields_match(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if arch == "paper-lsq":
        return
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.n_super, t.prefix_pattern) == (j.n_super, j.prefix_pattern)
    for tdt, jdt in ((t.act_dtype, j.act_dtype), (t.p_dtype, j.p_dtype)):
        assert str(tdt).removeprefix("torch.") == jdt.name


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_converted_param_count(arch):
    cfg = tconfigs.get_config(arch).reduced()
    jparams = jax.device_get(jlm.init_params(jax.random.PRNGKey(0),
                                             jconfigs.get_config(arch)
                                             .reduced()))
    params = convert.from_jax(jparams, cfg)
    n = convert.param_count(params)
    assert n == sum(np.size(a) for a in jax.tree.leaves(jparams))
    if not {"rwkv", "rec"} & set(cfg.block_pattern):
        # the JAX package's analytic count disagrees with its own
        # init_params for the recurrent blocks (ROADMAP queue 3), so the
        # recurrent archs are held to the JAX tree alone
        assert n == cfg.param_count()
    for pi in range(cfg.pattern_len):
        assert len(params["blocks"][f"p{pi}"]) == cfg.n_super


def test_converted_values_unstack_the_scan_axis():
    cfg = tconfigs.get_config("smollm-135m").reduced()
    jparams = jax.device_get(jlm.init_params(jax.random.PRNGKey(1),
                                             jconfigs.get_config(
                                                 "smollm-135m").reduced()))
    params = convert.from_jax(jparams, cfg)
    for s in range(cfg.n_super):
        np.testing.assert_array_equal(
            params["blocks"]["p0"][s]["attn"]["wq"].numpy(),
            jparams["blocks"]["p0"]["attn"]["wq"][s])
    np.testing.assert_array_equal(params["embed"].numpy(), jparams["embed"])


def test_bf16_params_convert_exactly():
    cfg = tconfigs.get_config("grok-1-314b").reduced(param_dtype="bfloat16")
    jcfg = jconfigs.get_config("grok-1-314b").reduced(param_dtype="bfloat16")
    jparams = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    params = convert.from_jax(jparams, cfg)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(jparams["embed"], np.float32))


@pytest.mark.parametrize("arch", SUPPORTED)
def test_port_init_params_count(arch):
    cfg = tconfigs.get_config(arch).reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    assert convert.param_count(params) == cfg.param_count()


def test_full_width_smollm_count_and_dtypes():
    cfg = tconfigs.get_config("smollm-135m")
    assert cfg.param_count() == jconfigs.get_config("smollm-135m") \
        .param_count() == 134515008
    assert cfg.act_dtype == torch.bfloat16 and cfg.p_dtype == torch.float32


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_unported_archs_raise(arch):
    """Each arch whose model is not ported (the vision and audio
    frontends) raises. recurrentgemma-2b, rwkv6-3b and the MoE archs run
    every path, the paged engine's included (tests/test_torch_lm.py,
    tests/test_torch_engine.py, tests/test_torch_moe*.py)."""
    cfg = tconfigs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError):
        tlm.init_params(0, cfg, device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tuple(tree.shape), tree.dtype


def test_recurrentgemma_tree_converts_leaf_for_leaf():
    """The JAX recurrentgemma tree (the rec subtree's log_lambda, conv_w,
    conv_b included) converts to exactly the port's own init tree: the
    same keys, shapes and dtypes, every layer unstacked."""
    cfg = tconfigs.get_config("recurrentgemma-2b").reduced()
    jparams = jax.device_get(jlm.init_params(
        jax.random.PRNGKey(0),
        jconfigs.get_config("recurrentgemma-2b").reduced()))
    got = convert.from_jax(jparams, cfg)
    want = tlm.init_params(0, cfg, device="cpu")
    assert list(_leaves(got)) == list(_leaves(want))
    rec = got["prefix"][0]["rec"]
    assert rec["log_lambda"].dtype == torch.float32
    np.testing.assert_array_equal(rec["log_lambda"].numpy(),
                                  jparams["prefix"][0]["rec"]["log_lambda"])
    np.testing.assert_array_equal(
        got["blocks"]["p1"][1]["rec"]["conv_w"].numpy(),
        jparams["blocks"]["p1"]["rec"]["conv_w"][1])


def test_rwkv_tree_converts_leaf_for_leaf():
    """The JAX rwkv6 tree (each layer's tmix / cmix) converts to exactly
    the port's own init tree: the same keys, shapes and dtypes, every
    layer unstacked, values equal."""
    cfg = tconfigs.get_config("rwkv6-3b").reduced()
    jparams = jax.device_get(jlm.init_params(
        jax.random.PRNGKey(0), jconfigs.get_config("rwkv6-3b").reduced()))
    got = convert.from_jax(jparams, cfg)
    want = tlm.init_params(0, cfg, device="cpu")
    assert list(_leaves(got)) == list(_leaves(want))
    assert {k for k in got["blocks"]["p0"][0]} == {"norm1", "norm2", "tmix",
                                                    "cmix"}
    np.testing.assert_array_equal(
        got["blocks"]["p0"][1]["tmix"]["bonus_u"].numpy(),
        jparams["blocks"]["p0"]["tmix"]["bonus_u"][1])
    np.testing.assert_array_equal(
        got["blocks"]["p0"][0]["cmix"]["w_v"].numpy(),
        jparams["blocks"]["p0"]["cmix"]["w_v"][0])


@pytest.mark.parametrize("arch,over", [
    ("grok-1-314b", {}), ("llama4-maverick-400b-a17b", {"n_experts": 16})],
    ids=["grok-1-314b", "llama4-16e"])
def test_moe_tree_converts_leaf_for_leaf(arch, over):
    """The JAX MoE tree (each MoE layer's router (D, E) float32 and its
    expert stacks w_gate / w_up (E, D, F), w_down (E, F, D)) converts to
    exactly the port's own init tree: the same keys, shapes and dtypes,
    every layer unstacked, values equal; and back (to_jax) to JAX's tree
    leaf for leaf, bit for bit."""
    cfg = tconfigs.get_config(arch).reduced(**over)
    jparams = jax.device_get(jlm.init_params(
        jax.random.PRNGKey(0), jconfigs.get_config(arch).reduced(**over)))
    got = convert.from_jax(jparams, cfg)
    want = tlm.init_params(0, cfg, device="cpu")
    assert list(_leaves(got)) == list(_leaves(want))
    pi = cfg.block_pattern.index("moe")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    moe = got["blocks"][f"p{pi}"][1]["moe"]
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F),
        "w_down": (E, F, D)}
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        moe["w_down"].numpy(), jparams["blocks"][f"p{pi}"]["moe"]["w_down"][1])
    back = convert.to_jax(got, cfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_params_needs_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_params(0, tconfigs.get_config("smollm-135m").reduced())

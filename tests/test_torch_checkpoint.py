"""repro_torch.checkpoint and runtime held to the JAX package on the CPU:
the reference's own tests (tests/test_checkpoint_ft.py) on port trees;
checkpoints crossing between the packages both ways with equal arrays
(bf16 and int32 leaves included); the port's payload bytes equal to
msgpack.packb's; its msgpack reader against msgpack.unpackb; convert's
to_jax as the inverse of from_jax; and the checkpoint module importing
neither msgpack nor zstandard at its top level. The reference's
remesh_state waits for the port's distributed layer."""
import ast
import json
import os
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import msgpack_lite  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import theory  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailureInjector, RestartableLoop, eta_budget, straggler_safe_inner_steps)
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(32, 16, generator=g),
                       "b": torch.zeros(16, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "m": [torch.randn(8, generator=g)]}


# ----------------------------------------------------------------------------
# the reference's tests, on the port
# ----------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree)
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 3
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_latest_and_gc(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, _tree(s), keep=2)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".ckpt")]
    assert len(files) == 2
    _, step = ckpt.restore(str(tmp_path), _tree())
    assert step == 5
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_integrity_check(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    mf = json.load(open(tmp_path / "manifest.json"))
    path = tmp_path / mf["file"]
    blob = path.read_bytes()
    path.write_bytes(blob[:-4] + b"\x00\x00\x00\x00")
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), _tree())


def test_async_checkpointer(tmp_path):
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree()
    want = tree["params"]["w"].clone()
    acp.save(11, tree)
    tree["params"]["w"].add_(1.0)    # the saved copy is taken at save()
    acp.wait()
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 11
    assert torch.equal(restored["params"]["w"], want)


def test_restartable_loop_survives_failures(tmp_path):
    def step_fn(state, step):
        return {"x": state["x"] + float(step + 1)}

    init = {"x": torch.tensor(0.0)}
    clean = RestartableLoop(str(tmp_path / "clean"), step_fn,
                            ckpt_every=3).run(init, 17)
    loop = RestartableLoop(str(tmp_path / "faulty"), step_fn, ckpt_every=3,
                           injector=FailureInjector(prob=0.25, seed=42))
    attempts, state = 0, None
    while attempts < 100:
        attempts += 1
        try:
            state = loop.run(init, 17)
            break
        except RuntimeError:
            continue
    assert state is not None, "never completed"
    assert attempts > 1, "no failure was injected — raise prob"
    assert float(state["x"]) == float(clean["x"]) == 17 * 18 / 2


def test_restartable_loop_async(tmp_path):
    def step_fn(state, step):
        return {"x": state["x"] * 2.0 + step}

    loop = RestartableLoop(str(tmp_path), step_fn, ckpt_every=2,
                           async_save=True)
    out = loop.run({"x": torch.tensor(1.0)}, 5)
    restored, step = ckpt.restore(str(tmp_path), out)
    assert step == 4 and torch.equal(restored["x"], out["x"])


def test_straggler_budgets():
    spec = theory.ProblemSpec(L=1.0, beta=1.0, B=1.0, lam=0.1)
    etas = [eta_budget(spec, 64, 32, t) for t in (1, 2, 4)]
    assert etas[0] > etas[1] > etas[2] > 0
    assert straggler_safe_inner_steps(100, 0.35) == 35
    assert straggler_safe_inner_steps(100, 0.0) == 1


def test_elastic_rebalance():
    from repro_torch.runtime.elastic import rebalance_plan
    assert rebalance_plan(n_old=16, n_new=8, b=128, T_remaining=10) == \
        (128, 20)
    assert rebalance_plan(n_old=8, n_new=16, b=128, T_remaining=20) == \
        (128, 10)
    assert rebalance_plan(n_old=4, n_new=3, b=2, T_remaining=5) == (2, 7)
    for n_old, n_new, bb, tr in [(4, 3, 2, 5), (16, 7, 3, 11),
                                 (5, 2, 1, 1), (2, 9, 4, 13)]:
        b, T = rebalance_plan(n_old=n_old, n_new=n_new, b=bb, T_remaining=tr)
        assert b * n_new * T >= bb * n_old * tr
        assert b * n_new * (T - 1) < bb * n_old * tr


def test_eta_budget_equals_jax():
    from repro.core import theory as jtheory
    from repro.runtime.fault_tolerance import eta_budget as jeta
    for sc in (False, True):
        for t in (1, 3, 8):
            assert eta_budget(theory.ProblemSpec(L=1.0, beta=1.0, B=1.0,
                                                 lam=0.1), 64, 32, t, sc) \
                == jeta(jtheory.ProblemSpec(L=1.0, beta=1.0, B=1.0, lam=0.1),
                        64, 32, t, sc)


# ----------------------------------------------------------------------------
# the format, shared with the JAX package
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_state():
    """Reduced smollm params (bf16 embed, to carry a bf16 leaf) and an AdamW
    state, in both layouts."""
    jcfg, tcfg = jget("smollm-135m").reduced(), tget("smollm-135m").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"] = jp["embed"].astype(jnp.bfloat16)
    jp["final_norm"] = jp["final_norm"] + 0.25
    js = jopt.adamw().init(jp)
    js = {**js, "count": jnp.int32(5),
          "m": jax.tree.map(lambda x: x + 1, js["m"])}
    jtree = jax.device_get({"params": jp, "opt": js})
    ttree = {"params": convert.from_jax(jtree["params"], tcfg),
             "opt": {"m": convert.from_jax(jtree["opt"]["m"], tcfg),
                     "v": convert.from_jax(jtree["opt"]["v"], tcfg),
                     "count": torch.tensor(5, dtype=torch.int32)}}
    return tcfg, jtree, ttree


def _assert_same(jtree, ttree_as_jax):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree_as_jax)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))


def test_jax_restores_a_port_checkpoint(tmp_path, model_state):
    tcfg, jtree, ttree = model_state
    ckpt.save(str(tmp_path), 12, ttree)
    restored, step = jckpt.restore(str(tmp_path), jtree)
    assert step == 12
    _assert_same(restored, jtree)
    assert np.asarray(restored["params"]["embed"]).dtype.name == "bfloat16"


def test_port_restores_a_jax_checkpoint(tmp_path, model_state):
    tcfg, jtree, ttree = model_state
    jckpt.save(str(tmp_path), 9, jtree)
    restored, step = ckpt.restore(str(tmp_path), ttree)
    assert step == 9
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["count"].dtype == torch.int32
    _assert_same(jtree, convert.to_jax(restored, tcfg))


def test_payload_bytes_equal_msgpack(model_state):
    """The port's msgpack bytes equal msgpack.packb(..., use_bin_type=True)
    of the same payload (msgpack exists here, not on the card's machine),
    and its reader gives msgpack.unpackb's objects."""
    import msgpack
    tcfg, _, ttree = model_state
    leaves = list(ckpt._jax_leaves(convert.stack_blocks(ttree)))
    payload = ckpt._payload(leaves)
    raw = msgpack_lite.packb(payload)
    assert raw == msgpack.packb(payload, use_bin_type=True)
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    mixed = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                      2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                      -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
             "s": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                   "e" * 65536], "bin": [b"", b"x" * 255, b"y" * 256,
                                         b"z" * 65536],
             "misc": [None, True, False, 1.5, list(range(15)),
                      list(range(16)), {str(i): i for i in range(16)}]}
    raw = msgpack_lite.packb(mixed)
    assert raw == msgpack.packb(mixed, use_bin_type=True)
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_compressed_blobs_are_read_by_their_magic(tmp_path):
    """A zlib stream at any level reads back; a zstd frame raises naming
    the package where `zstandard` does not import (it does not here)."""
    raw = msgpack_lite.packb([{"dtype": "float32", "shape": [2],
                               "data": np.ones(2, np.float32).tobytes()}])
    for level in (0, 6):
        (t,) = ckpt._decode(zlib.compress(raw, level))
        assert torch.equal(t, torch.ones(2))
    try:
        import zstandard  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="zstandard"):
            ckpt._decode(b"\x28\xb5\x2f\xfd" + raw)


def test_to_jax_inverts_from_jax(model_state):
    tcfg, jtree, ttree = model_state
    back = convert.to_jax(ttree["params"], tcfg)
    _assert_same(jtree["params"], back)
    again = convert.from_jax(back, tcfg)
    for a, b in zip(tree_leaves(again), tree_leaves(ttree["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    stacked = convert.stack_blocks(ttree)
    for a, b in zip(tree_leaves(convert.unstack_blocks(stacked, ttree)),
                    tree_leaves(ttree)):
        assert torch.equal(a, b)


def test_checkpoint_module_imports_no_msgpack_or_zstandard():
    src = (ROOT / "src" / "repro_torch" / "checkpoint" /
           "checkpoint.py").read_text()
    top = [n for n in ast.parse(src).body
           if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name.split(".")[0] for n in top for a in n.names} | {
        (n.module or "").split(".")[0] for n in top
        if isinstance(n, ast.ImportFrom)}
    assert not names & {"msgpack", "zstandard", "jax", "repro"}, names


def test_restore_keeps_the_port_tree_order(tmp_path):
    """A tree from the port's own init_params (layer dicts not in sorted
    key order, unlike JAX's) comes back with its keys in its own order,
    leaf for leaf bit-equal."""
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import sgd
    params = lm.init_params(0, tget("smollm-135m").reduced(), device="cpu")
    tree = {"params": params, "opt": sgd(momentum=0.9).init(params)}
    ckpt.save(str(tmp_path), 0, tree)
    back, _ = ckpt.restore(str(tmp_path), tree)
    assert list(back["params"]["blocks"]["p0"][0]) == \
        list(params["blocks"]["p0"][0])
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_adamw_state_checkpoint_roundtrip(tmp_path, model_state):
    """A port AdamW state over port params round-trips bit for bit."""
    *_, ttree = model_state
    opt = adamw()
    state = {"params": ttree["params"], "opt": opt.init(ttree["params"])}
    ckpt.save(str(tmp_path), 0, state)
    restored, _ = ckpt.restore(str(tmp_path), state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)

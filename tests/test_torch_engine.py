"""The port's serving engine held to the JAX engine on the CPU: one fixed
request stream (mixed lengths, a shared prefix, a stop token, a
speculate=2 run) through both, step by step. Greedy tokens, finish
reasons and the SchedulerStats after every step must be equal, and the
port engine must equal the port's generate() exactly."""
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.get_config("smollm-135m").reduced()
    tcfg = tconfigs.get_config("smollm-135m").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_jax(jax.device_get(jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _stream(kind, vocab):
    """(prompt, max_new, eos) triples of a fixed request stream."""
    rng = np.random.default_rng(7)
    if kind == "mixed":
        lens = [5, 12, 9, 15, 3, 11]
        return [(rng.integers(0, vocab, n).astype(np.int32), 6 + n % 5, None)
                for n in lens]
    if kind == "shared_prefix":
        prefix = rng.integers(0, vocab, 10).astype(np.int32)
        return [(np.concatenate([prefix, rng.integers(0, vocab, n)
                                 .astype(np.int32)]), 7, None)
                for n in (3, 6, 2, 5, 4)]
    pattern = rng.integers(0, vocab, 4).astype(np.int32)    # repetitive
    return [(np.tile(pattern, 5)[:n], 10, None) for n in (14, 18, 11)]


def _drive(engine, reqs):
    for r in reqs:
        engine.submit(r)
    stats = []
    engine.begin_run()
    while engine.has_work:
        engine.step()
        stats.append(dataclasses.asdict(engine.stats()))
    done = sorted(engine.scheduler.completions, key=lambda c: c.rid)
    engine.scheduler.completions = []
    return done, stats


KW = dict(num_slots=3, block_size=4, max_seq_len=32, prefill_max_batch=2)


@pytest.mark.parametrize("kind,speculate", [("mixed", 0),
                                            ("shared_prefix", 0),
                                            ("repetitive", 2)])
def test_engine_matches_jax_engine_and_generate(models, kind, speculate):
    jcfg, jparams, tcfg, tparams = models
    stream = _stream(kind, jcfg.vocab_size)
    if kind == "mixed":     # request 1 stops at its own third token
        p, m, _ = stream[1]
        eos = int(tserve.generate(tparams, tcfg, p[None], m, device="cpu")
                  [0, 2])
        stream[1] = (p, m, eos)
    jeng = JEngine(jparams, jcfg, speculate=speculate, prefix_cache=True,
                   **KW)
    teng = TEngine(tparams, tcfg, speculate=speculate, prefix_cache=True,
                   device="cpu", **KW)
    jdone, jstats = _drive(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=m,
                                           eos_id=e)
                                  for i, (p, m, e) in enumerate(stream)])
    tdone, tstats = _drive(teng, [TRequest(rid=i, prompt=p, max_new_tokens=m,
                                           eos_id=e)
                                  for i, (p, m, e) in enumerate(stream)])
    assert tstats == jstats
    assert len(tdone) == len(jdone) == len(stream)
    for tc, jc in zip(tdone, jdone):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
        assert (tc.finish_reason, tc.cached_tokens, tc.prompt_len) == \
            (jc.finish_reason, jc.cached_tokens, jc.prompt_len)
    assert teng.runner.prefill_shapes == jeng.runner.prefill_shapes
    assert teng.runner.verify_shapes == jeng.runner.verify_shapes
    for tc in tdone:
        p, m, _ = stream[tc.rid]
        want = tserve.generate(tparams, tcfg, p[None], m,
                               device="cpu").numpy()[0]
        np.testing.assert_array_equal(tc.tokens, want[:len(tc.tokens)])
    if kind == "mixed":
        assert tdone[1].finish_reason == "stop"
    if kind == "shared_prefix":
        assert sum(c.cached_tokens for c in tdone) > 0
    if speculate:
        assert teng.runner.verify_dispatches > 0


def test_pool_accounting_matches_jax(models):
    jcfg, _, tcfg, _ = models
    assert tkv.paged_bytes(tcfg, 33, 4) == jkv.paged_bytes(jcfg, 33, 4)
    assert tkv.block_bytes(tcfg, 16) == jkv.block_bytes(jcfg, 16)


def test_copy_block_copies_every_pool(models):
    _, _, tcfg, _ = models
    state = tkv.init_paged_state(tcfg, 2, 6, 4, device="cpu")
    for _, st in tkv.lm._layers(state, tcfg):
        st["k"][2].normal_()
        st["v"][2].normal_()
    tkv.copy_block(tcfg, state, 2, 5)
    for _, st in tkv.lm._layers(state, tcfg):
        assert torch.equal(st["k"][5], st["k"][2])
        assert torch.equal(st["v"][5], st["v"][2])


def test_engine_without_device_raises_without_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tparams, tcfg, **KW)


@pytest.mark.parametrize("kwargs", [dict(kv_dtype="int8"),
                                    dict(kv_dtype="fp8"),
                                    dict(host_cache_blocks=4)])
def test_unported_engine_options_raise(models, kwargs):
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError):
        TEngine(tparams, tcfg, device="cpu", **KW, **kwargs)


def test_sampled_requests_raise_not_fall_back(models):
    _, _, tcfg, tparams = models
    eng = TEngine(tparams, tcfg, device="cpu", **KW)
    req = TRequest(rid=0, prompt=np.arange(6, dtype=np.int32),
                   sampling=SamplingParams(temperature=0.8, seed=1,
                                           max_new_tokens=4))
    with pytest.raises(NotImplementedError):
        eng.run([req])


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "6", "10", "--max-new", "2", "4"])
    out = capsys.readouterr().out
    assert '"requests": 3' in out and '"device": "cpu"' in out


@pytest.mark.parametrize("flag", [["--replicas", "2"], ["--autoscale"],
                                  ["--slo-ttft-ms", "100"],
                                  ["--temperature", "0.5"]])
def test_serve_cli_later_slice_flags_stop(flag):
    with pytest.raises(SystemExit, match="not ported"):
        tserve.main(["--device", "cpu", *flag])


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """chip_smoke.py, run from a directory holding nothing else of the
    repo, exits non-zero and prints no result line: without a CUDA device
    it stops at that check, with one at the missing src/."""
    script = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    alone = shutil.copy(script, tmp_path)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

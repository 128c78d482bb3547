"""The port's serve CLI over the cluster and SLO layers, on the CPU at the
reduced smollm-135m: each of the seven flags the JAX CLI has and the port
lacked (--router, --min-replicas, --max-replicas, --queue-high,
--queue-low, --scale-cooldown, --slo-budget) reaches its layer; the eight
flags that once stopped the port's CLI (--replicas, --autoscale,
--slo-ttft-ms, --slo-latency-ms, --slo-shed, --slo-autoscale,
--deadline-ms, --flight-recorder) serve, and their JSON summary has the
keys of the JAX CLI's under the same flags (the JAX CLI runs as its own
process would, once per engine arm); the replicas of one CLI run hold one
tensor per weight leaf (equal data_ptr across runners), which an uncast
bf16 tree would not give them."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402
from _torch_cpu import time_limit  # noqa: E402,F401

_torch_cpu.share_cores()

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.replica import Replica  # noqa: E402

pytestmark = pytest.mark.serving

SMALL = ["--requests", "4", "--slots", "2", "--prompt-len", "6",
         "--max-new", "2", "4"]


def _stats(out):
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def _port_cli(argv, capsys):
    tserve.main(["--device", "cpu", *SMALL, *argv])
    return _stats(capsys.readouterr().out)


@pytest.mark.parametrize("flags,path,want", [
    (["--replicas", "2", "--router", "rr"], ("cluster", "policy"),
     "round-robin"),
    (["--replicas", "2", "--router", "prefix"], ("cluster", "policy"),
     "prefix-affinity"),
    (["--autoscale", "--min-replicas", "2"],
     ("cluster", "autoscaler", "policy", "min_replicas"), 2),
    (["--autoscale", "--max-replicas", "4"],
     ("cluster", "autoscaler", "policy", "max_replicas"), 4),
    (["--autoscale", "--queue-high", "3.5"],
     ("cluster", "autoscaler", "policy", "queue_high"), 3.5),
    (["--autoscale", "--queue-low", "0.5"],
     ("cluster", "autoscaler", "policy", "queue_low"), 0.5),
    (["--autoscale", "--scale-cooldown", "0.75"],
     ("cluster", "autoscaler", "policy", "cooldown_s"), 0.75),
    (["--slo-ttft-ms", "50", "--slo-budget", "0.2"],
     ("slo", "policy", "error_budget"), 0.2)],
    ids=["router-rr", "router-prefix", "min-replicas", "max-replicas",
         "queue-high", "queue-low", "scale-cooldown", "slo-budget"])
def test_new_flags_reach_their_layer(flags, path, want, capsys):
    stats = _port_cli(flags, capsys)
    node = stats
    for key in path:
        node = node[key]
    assert node == want
    assert stats["requests"] == 4
    if "--min-replicas" in flags:         # the cluster starts at 2
        assert stats["cluster"]["replicas"] == 2
    if "--max-replicas" in flags:         # 3 stacks wait in standby
        assert stats["cluster"]["autoscaler"]["standby_replicas"] + \
            stats["cluster"]["autoscaler"]["enabled_replicas"] == 4


def _shape(node):
    """The key structure of a JSON value: dicts by their keys, a list of
    dicts by its first element's."""
    if isinstance(node, dict):
        return {k: _shape(v) for k, v in node.items()}
    if isinstance(node, list) and node and isinstance(node[0], dict):
        return [_shape(node[0])]
    return None


def _assert_same_keys(port, ref, where=""):
    if isinstance(ref, dict):
        assert isinstance(port, dict), where
        assert set(ref) <= set(port), (where, set(ref) - set(port))
        for k in ref:
            _assert_same_keys(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list) and isinstance(port, list) and port:
        _assert_same_keys(port[0], ref[0], f"{where}[0]")


_JAX_KEYS = {}


def _jax_keys(argv, arm, capsys, monkeypatch):
    """The JSON key structure of the JAX CLI's summary for one engine arm
    (single engine / cluster / autoscaled, with or without the SLO
    layer), run once a process."""
    if arm not in _JAX_KEYS:
        pytest.importorskip("jax")
        from repro.launch import serve as jserve
        monkeypatch.setattr(sys, "argv", ["serve", *SMALL, *argv])
        jserve.main()
        _JAX_KEYS[arm] = _shape(_stats(capsys.readouterr().out))
    return _JAX_KEYS[arm]


@pytest.mark.parametrize("flags", [
    ["--replicas", "2"], ["--autoscale"], ["--slo-ttft-ms", "100"],
    ["--slo-latency-ms", "200"], ["--slo-shed"],
    ["--autoscale", "--slo-autoscale"], ["--deadline-ms", "500"],
    ["--flight-recorder", "flight.json"]],
    ids=["replicas", "autoscale", "slo-ttft-ms", "slo-latency-ms",
         "slo-shed", "slo-autoscale", "deadline-ms", "flight-recorder"])
def test_former_stops_serve_with_the_jax_cli_keys(flags, capsys, monkeypatch,
                                                  tmp_path):
    """Every former stop serves all 4 requests (completions plus shed
    requests), and its summary carries every key the JAX CLI prints for
    the same engine arm; the port adds only `device` and, for a cluster,
    `shared_weights`."""
    monkeypatch.chdir(tmp_path)           # the flight recorder's dump
    stats = _port_cli(flags, capsys)
    assert stats["requests"] + stats.get("shed_requests", 0) == 4
    cluster = "--replicas" in flags or "--autoscale" in flags
    slo = any(f.startswith("--slo") for f in flags)
    arm = ("autoscale" if "--autoscale" in flags else
           "cluster" if cluster else "engine") + ("+slo" if slo else "")
    ref = _jax_keys(flags, arm, capsys, monkeypatch)
    _assert_same_keys(_shape(stats), ref)
    extra = set(stats) - set(ref)
    assert extra <= {"device", "shared_weights"}, extra
    assert ("slo" in stats) == slo
    assert ("cluster" in stats) == cluster
    if cluster:
        assert stats["shared_weights"] is True
    if "--autoscale" in flags:
        assert stats["cluster"]["autoscaler"]["signal"] == (
            "slo-burn-rate" if slo else "queue-depth")
    if "--flight-recorder" in flags:
        doc = json.loads((tmp_path / "flight.json").read_text())
        assert tserve.validate_trace_events(doc) == []


def test_cluster_replicas_share_one_weight_copy(capsys, monkeypatch):
    """A bf16 model (the reduced smollm at dtype bfloat16) served by three
    replicas: the CLI casts once, so every runner holds the same tensor
    for every leaf (shared_weights, from data_ptr). Replicas built from
    the float32 masters instead each cast a copy of their own, which the
    same check sees."""
    cfg = get_config("smollm-135m").reduced(dtype="bfloat16")

    class _Arch:
        @staticmethod
        def reduced():
            return cfg

    monkeypatch.setattr(tserve, "get_config", lambda arch: _Arch)
    stats = _port_cli(["--replicas", "3"], capsys)
    assert stats["shared_weights"] is True and stats["requests"] == 4
    masters = lm.init_params(0, cfg, device="cpu")
    kw = dict(num_slots=2, block_size=4, max_seq_len=16, device="cpu")
    cast = lm.cast_params(masters, cfg)
    shared = [Replica(cast, cfg, replica_id=i, **kw) for i in range(2)]
    copied = [Replica(masters, cfg, replica_id=i, **kw) for i in range(2)]
    assert tserve._shared_weights(shared)
    assert not tserve._shared_weights(copied)
    assert shared[0].engine.runner.params["embed"].data_ptr() == \
        cast["embed"].data_ptr()

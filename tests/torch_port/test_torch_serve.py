"""``python -m repro_torch.launch.serve`` against ``python -m
repro.launch.serve``: the same flags (plus ``--device cpu``) print the
same metrics JSON, the wall-clock keys aside, in the closed and the event
loop, for IEMAS, a baseline and an adversarial fleet, and the hubs-of-hubs
federation (``--super-hubs``) with its shards inline and in their own
processes; and the flag checks refuse what the reference's refuse."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from _serving_parity import comparable  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402

CPU = ["--device", "cpu"]


def _ref_main(monkeypatch, capsys, flags) -> dict:
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    ref_serve.main()
    return json.loads(capsys.readouterr().out)


def _port_main(capsys, flags) -> dict:
    out = port_serve.main(flags + CPU)
    printed = json.loads(capsys.readouterr().out)
    assert comparable(printed) == comparable(json.loads(json.dumps(
        out, default=float)))
    return printed


@pytest.mark.parametrize("flags", [
    # the closed loop on analytic engines (real engines' decisions follow
    # measured TTFT, so only the analytic loop is bit-comparable)
    ["--engine-mode", "analytic", "--agents", "6", "--dialogues", "6",
     "--solver", "dense", "--hubs", "2", "--warm-start", "--audit-ledger"],
    ["--sim-mode", "event", "--agents", "8", "--dialogues", "12",
     "--arrival-rate", "8", "--solver", "dense", "--hubs", "2",
     "--warm-start", "--audit-ledger", "--fail-prob", "0.05"],
    ["--sim-mode", "event", "--agents", "6", "--dialogues", "8",
     "--solver", "mcmf", "--adversary", "freerider", "--audit-ledger"],
    ["--sim-mode", "event", "--agents", "6", "--dialogues", "8",
     "--arrival-rate", "6", "--router", "leastloaded"],
    ["--sim-mode", "event", "--agents", "6", "--dialogues", "8",
     "--arrival-rate", "8", "--solver", "dense", "--warm-start",
     "--incremental", "--workload", "dag_handoff"],
], ids=["closed", "event", "adversary", "baseline", "incremental-dag"])
def test_cli_json_matches_reference(flags, monkeypatch, capsys):
    ref = _ref_main(monkeypatch, capsys, flags)
    port = _port_main(capsys, flags)
    assert sorted(ref) == sorted(port)
    assert comparable(ref) == comparable(port)
    assert port["n"] > 0 and not port["truncated"]


@pytest.mark.parametrize("flags", [
    ["--fused", "--incremental", "--sim-mode", "event", "--warm-start"],
    ["--fused", "--hubs", "2"],
    ["--fused", "--router", "random"],
    ["--super-hubs", "2"],
    ["--super-hubs", "2", "--sim-mode", "event", "--router", "random"],
    ["--incremental"],
    ["--incremental", "--sim-mode", "event"],
    ["--workload", "dag_orchestrator"],
], ids=["fused-incremental", "fused-hubs", "fused-baseline",
        "super-hubs-closed", "super-hubs-baseline", "incremental-closed",
        "incremental-cold", "dag-closed"])
def test_cli_refuses_what_the_reference_refuses(flags, monkeypatch, capsys):
    for run in (lambda: _ref_main(monkeypatch, capsys, flags),
                lambda: port_serve.main(flags + CPU)):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
    capsys.readouterr()


FEDERATION = ["--sim-mode", "event", "--super-hubs", "2", "--agents", "16",
              "--dialogues", "40", "--arrival-rate", "30", "--solver",
              "dense", "--warm-start", "--audit-ledger"]


@pytest.mark.parametrize("parallel", ["inline", "process"])
def test_cli_federation_matches_reference(parallel, monkeypatch, capsys):
    """``--super-hubs 2``: the port's federation (its shards inline, or
    each in a spawned process) prints the reference CLI's JSON, the
    wall-clock keys of the merged report and of every shard aside."""
    flags = FEDERATION + ["--federation-parallel", parallel]
    ref = _ref_main(monkeypatch, capsys, FEDERATION)
    port = _port_main(capsys, flags)
    assert sorted(ref) == sorted(port)
    assert comparable(ref) == comparable(port)
    fed = port["federation"]
    assert fed["super_hubs"] == 2 and fed["exactly_once"]["ok"]
    assert [s["ledger"]["head"] for s in port["shards"]] == \
        [s["ledger"]["head"] for s in ref["shards"]]
    assert port["n"] > 0 and not port["truncated"]


@pytest.mark.parametrize("flags,why", [
    (["--fused", "--hubs", "1", "--warm-start"], "cannot be sharded"),
    (["--adversary", "freerider"], "single-heap"),
], ids=["fused", "adversary"])
def test_cli_refuses_the_federation(flags, why, monkeypatch, capsys):
    """Flag sets the federation cannot run, refused by both CLIs (exit 2);
    the port's error names the federation's reason."""
    flags = ["--sim-mode", "event", "--super-hubs", "2"] + flags
    with pytest.raises(SystemExit) as exc:
        _ref_main(monkeypatch, capsys, flags)
    assert exc.value.code == 2
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        port_serve.main(flags + CPU)
    assert exc.value.code == 2
    assert why in capsys.readouterr().err


def test_cli_names_the_ports_solvers_and_backends(capsys):
    for flags in (["--solver", "dense-jax"], ["--solver", "pallas"],
                  ["--predictor-backend", "jax"], ["--device", "tpu"]):
        with pytest.raises(SystemExit):
            port_serve.main(flags)
    capsys.readouterr()
    m = port_serve.main(["--sim-mode", "event", "--agents", "4",
                         "--dialogues", "3", "--predictor-backend", "torch",
                         "--hubs", "1", "--fused", "--warm-start"] + CPU)
    assert m["routing"]["fused"]["host_transfers"] == \
        m["routing"]["phases"]["route_batch"]["calls"]
    assert "phase2_solve[cuda]" not in m["routing"]["phases"]
    capsys.readouterr()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_runs_on_the_card_or_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--sim-mode", "event", "--agents", "3",
                         "--dialogues", "2"])

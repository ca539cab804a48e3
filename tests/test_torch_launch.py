"""The port's multi-process launcher, dry run and profiling tools on the CPU
(counterparts of tests/test_multiprocess_launch.py and the JAX package's
bench/ tools).

Two processes of `python -m magics_tpu_torch.parallel.launch --platform cpu
--backend gloo --check-sum` meet through the JAX launcher's MAGICS_*
variables or torchrun's, and agree with each other and with one process on
the global |positions| sum; `dryrun_multichip(2)` runs on the CPU over gloo;
the byte counter of bench/multichip_cost.py equals the exchange's traffic
model exactly; each profiling tool runs one variant for one tick; and the
entry points refuse what the machine does not have instead of falling back.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from magics_tpu_torch.bench import micro_ablate, multichip_cost, profile_slot, profile_tick
from magics_tpu_torch.entry import dryrun_multichip
from magics_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--platform", "cpu", "--backend", "gloo", "--robots", "32", "--ticks", "3",
        "--slots", "4", "--internal", "2", "--external", "2", "--check-sum"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(envs: list[dict]) -> list[str]:
    procs = []
    for extra in envs:
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore::FutureWarning",
                   **extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "magics_tpu_torch.parallel.launch", *ARGS],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _sums(outs: list[str]) -> list[str]:
    return [m for out in outs for m in re.findall(r"abs_pos_sum=(\S+)", out)]


@pytest.mark.parametrize("variables", ["magics", "torchrun"])
def test_two_processes_agree_with_each_other_and_one_process(variables):
    port = _free_port()
    if variables == "magics":
        envs = [dict(MAGICS_COORDINATOR=f"localhost:{port}", MAGICS_NUM_PROCESSES="2",
                     MAGICS_PROCESS_ID=str(r)) for r in range(2)]
    else:
        envs = [dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                     RANK=str(r)) for r in range(2)]
    outs = _launch(envs)
    assert "processes=2 backend=gloo device=cpu" in outs[0]
    assert re.search(r"R=32 shards=2 [\d.]+ ms/tick", outs[0])
    assert outs[0].count("rank_report ") == outs[1].count("rank_report ") == 1
    sharded = _sums(outs)
    one = _sums(_launch([{}]))
    assert len(sharded) == 2 and len(one) == 1
    assert sharded[0] == sharded[1] == one[0]


def test_dryrun_multichip_on_the_cpu():
    dryrun_multichip(2, device="cpu", backend="gloo")


@pytest.mark.parametrize("exchange", ["sender", "receiver_compact"])
def test_collective_bytes_equal_the_traffic_model(exchange):
    """2 ranks, 16 robots, one tick: the all_gathers of the exchange's table
    are 16 R K (V-1) (sender) or 32 R (V-1) (receiver_compact) bytes per
    external pass, 10 passes a tick, and the rest is far smaller."""
    rep = multichip_cost.measure(16, 2, exchange, platform="cpu", backend="gloo", ticks=1)
    V1, K = 20, 24
    per_pass = 16 * 16 * K * V1 if exchange == "sender" else 32 * 16 * V1
    assert rep["exchange_bytes_per_tick"] == rep["model_bytes_per_tick"] == 10 * per_pass
    assert 0 < rep["collective_bytes_per_tick"] - rep["exchange_bytes_per_tick"] < per_pass


@pytest.mark.parametrize("tool, argv, line", [
    (profile_tick, ["16", "--variants=pallas"], r"pallas +[\d.]+ ms/tick eager  \(cpu"),
    (micro_ablate, ["16", "--variants=no_collisions"], r"no_collisions +[\d.]+ ms/tick eager"),
    (profile_slot, ["16", "2"], r"K1 chain, SDF all ones +[\d.]+ ms/slot"),
])
def test_profiling_tools_run_one_tick_on_the_cpu(tool, argv, line, capsys):
    extra = [] if tool is profile_slot else ["--ticks", "1"]
    assert tool.main([*argv, "--platform", "cpu", *extra]) == 0
    assert re.search(line, capsys.readouterr().out)


def test_entry_points_refuse_what_the_machine_lacks(monkeypatch):
    """No card: the launcher, the dry run and the tools raise unless asked
    for the CPU; nccl asks for a card per rank and the CPU takes gloo only.
    Nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.main(["--robots", "16"])
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun_multichip(2)
    with pytest.raises(ValueError, match="gloo"):
        dryrun_multichip(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="nccl"):
        launch.main(["--platform", "cpu", "--backend", "nccl"])
    with pytest.raises(RuntimeError, match="one card per rank"):
        launch.spawn_ranks(print, 2, backend="nccl")
    for tool in (profile_tick, micro_ablate, profile_slot, multichip_cost):
        with pytest.raises(SystemExit, match="is_available"):
            tool.main(["16"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        launch._device("cuda", "nccl", 1, 2)
    assert launch._device("cuda", "gloo", 1, 2) == torch.device("cuda", 0)

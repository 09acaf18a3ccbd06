"""``python -m scl_slam_tpu_torch.run_multi`` on the CPU: the in-process
session and the process-per-robot one over sockets print the JSON report
with inter-robot loops; the default device is the card; ``--fleet`` over
tcp exits 2 (``--fleet`` runs: ``test_torch_fleet.py``); a worker that
fails fails the run, and one that is respawned resumes from its
checkpoint.
"""
import contextlib
import io
import json
import os

import pytest
import torch

from scl_slam_tpu_torch import run_multi, run_robot

torch.set_num_threads(2)

SMALL = """\
keyframe:
  max_keyframes: 64
  points_per_keyframe: 1024
  raw_points_capacity: 4096
loop:
  near_keyframes: 4
  submap_capacity: 2048
  icp_iterations: 10
  queue_capacity: 32
optimizer:
  edge_capacity: 256
  gn_iters: 4
  cg_iters: 24
"""


@pytest.fixture
def small_args(tmp_path):
    path = tmp_path / "small.yaml"
    path.write_text(SMALL)
    return ["--robots", "2", "--frames", "40", "--device", "cpu",
            "--config", str(path), "--output", str(tmp_path / "out")]


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tcp_report(tmp_path_factory):
    """The process-per-robot run at 40 frames, run once for the tests that
    hold it and the respawned run against it."""
    tmp = tmp_path_factory.mktemp("tcp")
    (tmp / "small.yaml").write_text(SMALL)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_multi.main(["--robots", "2", "--frames", "40", "--device", "cpu", "--config",
                             str(tmp / "small.yaml"), "--output", str(tmp / "out"), "--transport", "tcp"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_run_multi_local_on_cpu(small_args, tmp_path, capsys):
    assert run_multi.main(small_args) == 0
    rep = _report(capsys)
    assert rep["mode"] == "decentralized" and rep["robots"] == 2 and rep["device"] == "cpu"
    assert rep["frames"] == 40 and rep["inter_loops"] >= 1, rep
    assert set(rep["ate_rmse_m"]) == {"a", "b"} and max(rep["ate_rmse_m"].values()) < 0.1
    assert sorted(os.listdir(tmp_path / "out")) == ["a_kitti.txt", "a_tum.txt", "b_kitti.txt", "b_tum.txt"]


def test_run_multi_tcp_two_processes_on_cpu(tcp_report):
    rep = tcp_report
    assert rep["mode"] == "decentralized-tcp" and rep["device"] == "cpu"
    assert rep["inter_loops"] >= 1, rep
    assert set(rep["ate_rmse_m"]) == {"a", "b"} and max(rep["ate_rmse_m"].values()) < 0.1


def test_failed_worker_fails_the_run(small_args, capsys):
    assert run_multi.main(small_args + ["--transport", "tcp", "--crash-robot", "1",
                                        "--crash-after", "2"]) == 1
    assert "worker exit codes" in capsys.readouterr().err


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        run_multi.require_device("cuda")
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_multi.main(["--robots", "2", "--frames", "4"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_multi.main(["--robots", "2", "--frames", "4", "--transport", "tcp"])
    run_multi.require_device("cpu")


def test_fleet_over_tcp_exits_2(small_args, capsys):
    assert run_multi.main(small_args + ["--fleet", "--transport", "tcp"]) == 2
    assert "no tcp" in capsys.readouterr().err


def test_tcp_respawn_resumes_crashed_worker(small_args, tcp_report, capsys):
    """Robot 0 crashes after 12 of its 20 frames; the supervisor starts it
    again with --resume, from its checkpoint at 10 (tests/test_run_multi_tcp.py's
    bounds: a whole report, inter loops, both ATEs under 1 m). On the CPU
    the resumed run closes the uncrashed run's inter loops and ends at its
    ATE (13 loops in both measured)."""
    assert run_multi.main(small_args + ["--transport", "tcp", "--respawn", "2", "--checkpoint-every", "5",
                                        "--crash-robot", "0", "--crash-after", "12"]) == 0
    out, err = capsys.readouterr()
    rep = json.loads(out.strip().splitlines()[-1])
    assert "respawn 1/2" in err and "respawn 2/2" not in err and rep["respawns"] == 1
    assert rep["mode"] == "decentralized-tcp" and rep["inter_loops"] >= 1, rep
    assert set(rep["ate_rmse_m"]) == {"a", "b"} and max(rep["ate_rmse_m"].values()) < 1.0
    assert rep["inter_loops"] == tcp_report["inter_loops"]
    assert rep["ate_rmse_m"] == tcp_report["ate_rmse_m"]


def test_worker_checkpoint_and_resume(small_args, tmp_path):
    """One worker alone: a run that checkpoints every 5 frames, then a
    --resume run in the same directory, which restarts at the checkpoint's
    cursor (frame 10 of 12) and reports what the whole run reported."""
    argv = small_args[:]
    argv[argv.index("--robots") + 1] = "1"
    argv[argv.index("--frames") + 1] = "12"
    argv += ["--robot", "0", "--ports", "auto", "--workdir", str(tmp_path), "--checkpoint-every", "5"]
    assert run_robot.main(argv) == 0
    whole = json.loads((tmp_path / "out_0").read_text())
    assert (tmp_path / "ckpt_0.npz").exists() and (tmp_path / "ckpt_counters_0").exists()
    assert run_robot.main(argv + ["--resume", "--crash-after", "1"]) == 0  # ignored on resume
    resumed = json.loads((tmp_path / "out_0").read_text())
    assert resumed == whole and whole["counts"] == [whole["counts"][0]] and whole["counts"][0] > 0

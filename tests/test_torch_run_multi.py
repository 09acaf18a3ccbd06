"""``python -m scl_slam_tpu_torch.run_multi`` on the CPU: the in-process
session and the process-per-robot one over sockets print the JSON report
with inter-robot loops; the default device is the card; the options that
are not ported yet exit 2 (``--fleet`` runs: ``test_torch_fleet.py``); a
worker that fails fails the run.
"""
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


def test_run_multi_local_on_cpu(small_args, tmp_path, capsys):
    assert run_multi.main(small_args) == 0
    rep = _report(capsys)
    assert rep["mode"] == "decentralized" and rep["robots"] == 2 and rep["device"] == "cpu"
    assert rep["frames"] == 40 and rep["inter_loops"] >= 1, rep
    assert set(rep["ate_rmse_m"]) == {"a", "b"} and max(rep["ate_rmse_m"].values()) < 0.1
    assert sorted(os.listdir(tmp_path / "out")) == ["a_kitti.txt", "a_tum.txt", "b_kitti.txt", "b_tum.txt"]


def test_run_multi_tcp_two_processes_on_cpu(small_args, capsys):
    assert run_multi.main(small_args + ["--transport", "tcp"]) == 0
    rep = _report(capsys)
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


@pytest.mark.parametrize("opts", [["--fleet", "--respawn", "1"], ["--respawn", "1"],
                                  ["--checkpoint-every", "5"]])
def test_options_not_ported_exit_2(small_args, capsys, opts):
    assert run_multi.main(small_args + opts) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "checkpoint" in err


@pytest.mark.parametrize("opts", [["--resume"], ["--checkpoint-every", "3"]])
def test_worker_resume_exits_2(small_args, tmp_path, capsys, opts):
    argv = small_args + ["--robot", "0", "--ports", "auto", "--workdir", str(tmp_path)] + opts
    assert run_robot.main(argv) == 2
    assert "checkpoint module" in capsys.readouterr().err

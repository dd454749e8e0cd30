"""The port's examples: ``examples/rollout_example.py`` writes a video of a
validation episode on the CPU (where gymnasium imports), and
``examples/train_gpu.sh`` launches the training CLI with the config file,
through torchrun for several GPUs and with the distributed variables under
a multi-task SLURM job (fake ``python`` / ``torchrun`` / ``scontrol`` on
``PATH`` record what they were given)."""

import os
import subprocess

import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "torchdriveenv_tpu_torch", "examples",
                      "train_gpu.sh")
RECORDED = ("TDE_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WANDB_MODE")


def test_rollout_example_writes_a_video(tmp_path):
    pytest.importorskip("gymnasium")
    pytest.importorskip("PIL")
    from torchdriveenv_tpu_torch.examples import rollout_example
    out = str(tmp_path / "episode.avi")
    res = rollout_example.main(["--out", out, "--device", "cpu"])
    assert 1 <= res["steps"] <= 200
    assert os.path.getsize(out) > 1000
    with open(out, "rb") as f:
        head = f.read(12)
    assert head[:4] == b"RIFF" and head[8:12] == b"AVI "


def _fake_bin(tmp_path):
    """``python``, ``torchrun`` and ``scontrol`` stand-ins: the first two
    write their arguments, working directory and the launch variables to
    ``calls``; ``scontrol show hostnames`` prints the job's hosts, a large
    allocation's worth (a reader that stops at the first line must not fail
    the script)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    record = "\n".join(
        [f'echo "{name}=${{{name}:-}}" >> "$CALLS"' for name in RECORDED])
    for prog in ("python", "torchrun"):
        (bin_dir / prog).write_text(
            "#!/bin/bash\n"
            f'echo "{prog} $*" >> "$CALLS"\n'
            'echo "cwd=$PWD" >> "$CALLS"\n' + record + "\n")
    (bin_dir / "scontrol").write_text(
        "#!/bin/bash\n"
        '[[ "$1 $2" == "show hostnames" ]] && printf "gpu-a7\\n" && '
        'seq -f "gpu-b%g" 1 20000\n')
    for p in bin_dir.iterdir():
        p.chmod(0o755)
    return bin_dir


def _launch(tmp_path, **env):
    bin_dir = _fake_bin(tmp_path)
    calls = tmp_path / "calls"
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("SLURM_", "GPUS")) and k not in RECORDED}
    full.update(PATH=f"{bin_dir}:{os.environ['PATH']}", CALLS=str(calls),
                **env)
    subprocess.run(["bash", SCRIPT, "cfg/run.yml", "--max_wall_s", "5"],
                   env=full, check=True, timeout=60, cwd=str(tmp_path))
    lines = calls.read_text().splitlines()
    return lines[0], dict(line.split("=", 1) for line in lines[1:])


def test_one_gpu_runs_the_cli_with_the_config(tmp_path):
    cmd, env = _launch(tmp_path)
    assert cmd == ("python -m torchdriveenv_tpu_torch.rl.train --config_file "
                   "cfg/run.yml --max_wall_s 5")
    assert env["cwd"] == ROOT and env["WANDB_MODE"] == "offline"
    assert env["TDE_DISTRIBUTED"] == "" and env["MASTER_ADDR"] == ""


def test_several_gpus_go_through_torchrun(tmp_path):
    cmd, env = _launch(tmp_path, GPUS="4", WANDB_MODE="online")
    assert cmd == ("torchrun --nproc_per_node=4 -m "
                   "torchdriveenv_tpu_torch.rl.train --config_file "
                   "cfg/run.yml --max_wall_s 5")
    assert env["WANDB_MODE"] == "online"


def test_a_slurm_job_exports_the_distributed_variables(tmp_path):
    cmd, env = _launch(tmp_path, SLURM_NTASKS="2", SLURM_PROCID="1",
                       SLURM_JOB_NODELIST="gpu-a7,gpu-b[1-20000]")
    assert cmd == ("python -m torchdriveenv_tpu_torch.rl.train --config_file "
                   "cfg/run.yml --max_wall_s 5")
    assert env["TDE_DISTRIBUTED"] == "1"
    assert env["MASTER_ADDR"] == "gpu-a7" and env["MASTER_PORT"] == "29500"


def test_a_one_task_slurm_job_is_one_process(tmp_path):
    cmd, env = _launch(tmp_path, SLURM_NTASKS="1",
                       SLURM_JOB_NODELIST="gpu-a7")
    assert cmd.startswith("python -m torchdriveenv_tpu_torch.rl.train")
    assert env["TDE_DISTRIBUTED"] == "" and env["MASTER_ADDR"] == ""

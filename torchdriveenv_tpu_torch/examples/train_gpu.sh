#!/bin/bash
# GPU / SLURM launch script of the port's training CLI (the counterpart of
# examples/train_tpu.sh, the reference's examples/train.sh re-targeted).
#
#   bash torchdriveenv_tpu_torch/examples/train_gpu.sh <config.yml> [flags]
#
# One GPU: python -m torchdriveenv_tpu_torch.rl.train. GPUS=N (N > 1) on one
# host: torchrun --nproc_per_node=N, data parallel over the N cards. SLURM,
# one task per GPU, the script run by every task:
#   sbatch --ntasks=<world> --gpus-per-task=1 \
#     --wrap "srun bash torchdriveenv_tpu_torch/examples/train_gpu.sh <config.yml>"
# With more than one task it exports TDE_DISTRIBUTED=1 and MASTER_ADDR /
# MASTER_PORT (the job's first host), which
# torchdriveenv_tpu_torch/parallel/mesh.py:maybe_init_distributed reads
# beside SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID.
#
#SBATCH --cpus-per-task=16
#SBATCH --mem-per-cpu=8G
#SBATCH --time=7-00:00:00

set -euo pipefail

CONFIG="${1:-examples/env_configs/multi_agent/sac_training.yml}"
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
cd "$REPO_ROOT"

# Offline by default: wandb logs locally (rl/train.py runs without it);
# export WANDB_MODE=online (and WANDB_API_KEY) to stream.
export WANDB_MODE="${WANDB_MODE:-offline}"
GPUS="${GPUS:-1}"

if [[ -n "${SLURM_NTASKS:-}" && "${SLURM_NTASKS}" != "1" ]]; then
  export TDE_DISTRIBUTED=1
  # the job's first host (no `| head`: under pipefail its early exit fails
  # the pipeline with SIGPIPE)
  HOSTS="$(scontrol show hostnames "${SLURM_JOB_NODELIST}")"
  export MASTER_ADDR="${HOSTS%%$'\n'*}"
  export MASTER_PORT="${MASTER_PORT:-29500}"
  exec python -m torchdriveenv_tpu_torch.rl.train --config_file "$CONFIG" "${@:2}"
fi

if [[ "$GPUS" -gt 1 ]]; then
  exec torchrun --nproc_per_node="$GPUS" -m torchdriveenv_tpu_torch.rl.train \
    --config_file "$CONFIG" "${@:2}"
fi
exec python -m torchdriveenv_tpu_torch.rl.train --config_file "$CONFIG" "${@:2}"

#!/usr/bin/env bash
# Camera-view generalization sweep on the port: evaluate a trained checkpoint
# under the MultiView camera rigs with
# `python -m pointcloudmatters_tpu_torch.validate`, the same loops and
# overrides as scripts/run_maniskill2_camera_view.sh (which drives the JAX
# package): point-cloud models sweep camera_ids 4-7 (left/down at 5 and 10
# degrees in the MultiView rig order); image models sweep the same views by
# camera name. Every env id swept here is produced by
# pointcloudmatters_tpu_torch.envs.custom_maniskill2.iter_env_ids();
# tests/test_torch_scripts.py asserts script<->registry consistency.
#
# Usage: bash pointcloudmatters_tpu_torch/scripts/run_maniskill2_camera_view.sh <CKPT> <TASK> <MODEL> <SEED>
set -euo pipefail

repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${repo}${PYTHONPATH:+:${PYTHONPATH}}"

ckpt_path=${1:?checkpoint path}
task=${2:?task, e.g. PickCube-v0}
model=${3:?model variant, e.g. scratch_pointnet_pcd}
seed=${4:?seed}

base=${task%-v0}
env_id="${base}-MultiView"
[ "$base" = "PegInsertionSide" ] && env_id="PegInsertionSide-3steps-MultiView"
echo ">>> task=${task} model=${model} env_id=${env_id} seed=${seed}"

run_eval() { # <task_group> [extra overrides...]
  local group=$1
  shift
  python -m pointcloudmatters_tpu_torch.validate exp_maniskill2_act_policy=base \
    "exp_maniskill2_act_policy/${group}@${group}=${task}" \
    "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=${model}" \
    "ckpt_path=${ckpt_path}" "model.env_id=${env_id}" "seed=${seed}" "$@"
}

if [[ "$model" == *"pcd"* ]]; then
  # MultiView rig order puts the perturbed views at ids 4-7:
  #   4 left_camera_5 | 5 down_camera_5 | 6 left_camera_10 | 7 down_camera_10
  for cam in 4 5 6 7; do
    echo ">>> camera_id=${cam}"
    run_eval maniskill2_pcd_task "data.train.camera_ids=[${cam}]"
  done
else
  for cam in left_camera_5 left_camera_10 down_camera_5 down_camera_10; do
    echo ">>> camera=${cam}"
    run_eval maniskill2_task "data.train.camera_names=[${cam}]"
  done
fi

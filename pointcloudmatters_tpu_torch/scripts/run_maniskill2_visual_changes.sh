#!/usr/bin/env bash
# Visual-change generalization sweep on the port over a trained StackCube
# checkpoint with `python -m pointcloudmatters_tpu_torch.validate`, the same
# loops and overrides as scripts/run_maniskill2_visual_changes.sh (which
# drives the JAX package):
#   axis 1  ambient light intensity   {0.03 0.05 0.15 0.6 1.8 3}
#   axis 2  ray-tracing sample noise  {2 16 32 64}  (shader_dir=rt, no denoiser)
#   axis 3  background color          red/green x {0.2 0.6 1.0}
# Every env id swept here is produced by
# pointcloudmatters_tpu_torch.envs.custom_maniskill2.iter_env_ids();
# tests/test_torch_scripts.py asserts script<->registry consistency.
#
# Usage: bash pointcloudmatters_tpu_torch/scripts/run_maniskill2_visual_changes.sh <CKPT> <MODEL> <SEED>
set -euo pipefail

repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${repo}${PYTHONPATH:+:${PYTHONPATH}}"

ckpt_path=${1:?checkpoint path}
model=${2:?model variant, e.g. scratch_pointnet_pcd}
seed=${3:?seed}

run_eval() { # <env_id> <task_name> [extra overrides...]
  local env_id=$1 task_name=$2
  shift 2
  echo ">>> ${task_name}  (env_id=${env_id})"
  python -m pointcloudmatters_tpu_torch.validate exp_maniskill2_act_policy=base \
    "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=StackCube-v0" \
    "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=${model}" \
    "ckpt_path=${ckpt_path}" "model.env_id=${env_id}" \
    "task_name=${task_name}" "seed=${seed}" "$@"
}

for light in 0.03 0.05 0.15 0.6 1.8 3; do
  run_eval "StackCube-light-${light}" "${model}-light-${light}"
done

for noise in 2 16 32 64; do
  run_eval "StackCube-v0" "${model}-noise-${noise}" \
    "model.shader_dir=rt" "model.rt_samples_per_pixel=${noise}" \
    "model.rt_use_denoiser=false"
done

for level in 0.2 0.6 1.0; do
  run_eval "StackCube-background-red-${level}" "${model}-red_color-${level}"
  run_eval "StackCube-background-green-${level}" "${model}-green_color-${level}"
done

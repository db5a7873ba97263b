#!/usr/bin/env bash
# RLBench camera-view perturbation sweep on the port: rotate/translate the
# front camera at evaluation time and measure the success rate with
# `python -m pointcloudmatters_tpu_torch.test_rlbench_act`, the same loops
# and overrides as scripts/run_rlbench_camera_view.sh (which drives the JAX
# package).
# Usage: bash pointcloudmatters_tpu_torch/scripts/run_rlbench_camera_view.sh <MODEL> <TASK> <CKPT>
set -euo pipefail

repo=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${repo}${PYTHONPATH:+:${PYTHONPATH}}"

MODEL=${1:?model variant, e.g. scratch_pointnet_pcd}
TASK=${2:?rlbench task, e.g. close_jar}
CKPT=${3:?checkpoint path}

for angle in 5 10 15 20; do
  for axis in y z; do
    python -m pointcloudmatters_tpu_torch.test_rlbench_act \
      "exp_rlbench_act_policy=base" \
      "exp_rlbench_act_policy/rlbench_model@rlbench_model=${MODEL}" \
      "rlbench_task=${TASK}" \
      "ckpt_path=${CKPT}" \
      "camera_view_test.apply=true" \
      "camera_view_test.rot_axis=${axis}" \
      "camera_view_test.rot_angle=${angle}" \
      "result_name=${MODEL}_${axis}_${angle}"
  done
done

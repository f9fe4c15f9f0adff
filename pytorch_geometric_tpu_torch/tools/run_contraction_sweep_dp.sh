#!/usr/bin/env bash
# Data-parallel contraction-coefficient sweep of the port's research
# driver, the grid of the repository's run_contraction_sweep_dp.sh (the
# reference's run_ContractionCoefficientsChanges_2gpus.sh:5-18): dataset x
# coefficient x batch size, TopK graph classification over --gpus ranks,
# one NCCL rank a card, each run's output kept in Logs/ through tee.
# DEVICES defaults to 1: more ranks than cards raise.
set -euo pipefail
DEVICES="${DEVICES:-1}"
EPOCHS="${EPOCHS:-20}"
mkdir -p Logs
for dataset in ENZYMES MUTAG; do
  for coeff in 0.4 0.6 0.8; do
    for bs in 32 64; do
      log="Logs/${dataset}-TopK-dp${DEVICES}-C${coeff}-B${bs}.log"
      python -m pytorch_geometric_tpu_torch.research.driver \
        --dataset "${dataset}" --modelName TopK \
        --ConCoeff "${coeff}" --Batch_size "${bs}" \
        --epochs "${EPOCHS}" --fine_tune_epochs "${EPOCHS}" \
        --gpus "${DEVICES}" --MonteSize 1 \
        2>&1 | tee "${log}"
    done
  done
done

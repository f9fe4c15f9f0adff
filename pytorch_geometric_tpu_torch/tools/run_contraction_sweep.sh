#!/usr/bin/env bash
# Contraction-coefficient sweep of the port's research driver, the grid of
# the repository's run_contraction_sweep.sh (the reference's
# run_ContractionCoefficientsChanges_{1,2}gpus.sh:5-21): dataset x model x
# coefficient, each run's output kept in Logs/ through tee. On the card.
set -u
mkdir -p Logs

DATASETS=${DATASETS:-"Cora"}
MODELS=${MODELS:-"GCN"}
CONCOEFFS=${CONCOEFFS:-"0.4 0.6 0.8"}
EPOCHS=${EPOCHS:-100}
FINE=${FINE:-100}
MONTE=${MONTE:-3}

for dataset in $DATASETS; do
  for model in $MODELS; do
    for coeff in $CONCOEFFS; do
      echo "=== $dataset $model ConCoeff=$coeff ==="
      python -m pytorch_geometric_tpu_torch.research.driver \
        --dataset "$dataset" --modelName "$model" \
        --ConCoeff "$coeff" --epochs "$EPOCHS" \
        --fine_tune_epochs "$FINE" --MonteSize "$MONTE" \
        2>&1 | tee "Logs/${dataset}-${model}-${coeff}.log"
    done
  done
done

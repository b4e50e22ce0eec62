#!/usr/bin/env bash
# FlyingThings temporal evaluation on the PyTorch port (reference
# sceneflow_evaluate.sh): the sequences shared over one process per card
# (NGPUS, by default all), the single-process results.
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.evaluate --dataset things --sharded "$@"

#!/usr/bin/env bash
# TartanAir sequence evaluation on the PyTorch port (reference
# tartanair_evaluate.sh): EPE/D1/D3 and the temporal metrics over the held-out
# sequences, shared over one process per card (NGPUS, by default all).
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.evaluate --dataset TartanAir --sharded "$@"

#!/usr/bin/env bash
# TartanAir training recipe on the PyTorch port (reference
# tartanair_ddp_train.sh): 100k steps, batch 4 per card, lr 2e-4, crop 480x640,
# frame_length 4, iters 5; one process per card (NGPUS, by default all).
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.train --recipe TartanAir --validate "$@"

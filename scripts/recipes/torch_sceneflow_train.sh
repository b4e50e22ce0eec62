#!/usr/bin/env bash
# SceneFlow training recipe on the PyTorch port (reference sceneflow_ddp_train.sh):
# one process per card (NGPUS, by default every card of the host) under DDP,
# batch 4 per card, on tcs_tpu's global-batch losses.
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.train --recipe sceneflow --validate "$@"

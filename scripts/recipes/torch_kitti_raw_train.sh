#!/usr/bin/env bash
# KITTI raw fine-tune recipe on the PyTorch port (reference KITTI_ddp_train.sh):
# 60k steps, lr 1e-4, crop 320x1024, frame_length 4, from the TartanAir
# weights (pass --restore_ckpt); one process per card (NGPUS, by default all).
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.train --recipe kitti_raw "$@"

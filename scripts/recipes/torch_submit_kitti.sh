#!/usr/bin/env bash
# KITTI 2015 sequence submission on the PyTorch port (reference
# submit_kitti.sh): frame 10 as a uint16 PNG x256 and the FPS; each process
# (NGPUS, by default every card) streams and writes its share of the scenes.
set -euo pipefail
cd "$(dirname "$0")/../.."
NGPUS=${NGPUS:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}
exec python -m torch.distributed.run --standalone --nproc_per_node="$NGPUS" \
    -m tcs_tpu_torch.cli.evaluate --dataset kitti --sharded "$@"

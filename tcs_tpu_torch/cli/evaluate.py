"""Evaluation CLI of the port (``scripts/evaluate.py``; reference
``evaluate_stereo.py __main__`` and the ``*_evaluate.sh`` /
``submit_kitti.sh`` scripts).

Examples:
  python -m tcs_tpu_torch.cli.evaluate --dataset TartanAir --restore_ckpt tartanair.pth
  python -m tcs_tpu_torch.cli.evaluate --dataset things --restore_ckpt sceneflow.pth
  python -m tcs_tpu_torch.cli.evaluate --dataset kitti --restore_ckpt kitti.pth
  python -m tcs_tpu_torch.cli.evaluate --dataset TartanAir --device cpu
  python -m torch.distributed.run --nproc_per_node 2 -m tcs_tpu_torch.cli.evaluate \
      --dataset TartanAir --sharded --restore_ckpt tartanair.pth

``--restore_ckpt`` takes a ``.pth`` file in the reference's format
(:mod:`tcs_tpu_torch.utils.checkpoint`); without it the model keeps weights
drawn from seed 0. ``--sharded`` under ``python -m torch.distributed.run``
streams each process's share of the sequences on its own card and gives the
single-process results (``evaluate.py``); without the launcher it is the
single-process run. The result dict is printed as the last line, in JSON, by
the first process.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["kitti", "things", "TartanAir"])
    p.add_argument("--restore_ckpt", default=None,
                   help="weights as a .pth file in the reference's format")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--valid_iters", type=int, default=5)
    p.add_argument("--max_sequences", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: this process's card) or 'cpu'")
    p.add_argument("--sharded", action="store_true",
                   help="share the sequences over the processes of python -m "
                        "torch.distributed.run, one stream each")
    # Architecture choices, as the reference duplicates them between its
    # train and evaluation CLIs (evaluate_stereo.py:354-373): a checkpoint
    # trained with non-default architecture flags needs the same flags to
    # evaluate. Defaults of None keep ModelConfig's defaults.
    p.add_argument("--corr_levels", type=int, default=None)
    p.add_argument("--corr_radius", type=int, default=None)
    p.add_argument("--n_downsample", type=int, default=None)
    p.add_argument("--n_gru_layers", type=int, default=None)
    p.add_argument("--hidden_dims", type=int, nargs="+", default=None)
    p.add_argument("--context_norm", default=None,
                   choices=["group", "batch", "instance", "none"])
    p.add_argument("--shared_backbone", dest="shared_backbone",
                   action="store_true", default=None)
    p.add_argument("--no_shared_backbone", dest="shared_backbone",
                   action="store_false")
    p.add_argument("--slow_fast_gru", dest="slow_fast_gru",
                   action="store_true", default=None)
    p.add_argument("--mixed_precision", dest="mixed_precision",
                   action="store_true", default=None)
    p.add_argument("--no_mixed_precision", dest="mixed_precision",
                   action="store_false")
    return p.parse_args(argv)


def build_model_config(args):
    """The architecture flags onto ``ModelConfig`` (``scripts/evaluate.py``'s
    mapping)."""
    from tcs_tpu_torch.config import ModelConfig

    overrides = {}
    for key in ("corr_levels", "corr_radius", "n_downsample", "n_gru_layers",
                "context_norm", "shared_backbone", "slow_fast_gru",
                "mixed_precision"):
        v = getattr(args, key)
        if v is not None:
            overrides[key] = v
    if args.hidden_dims is not None:
        overrides["hidden_dims"] = tuple(args.hidden_dims)
        overrides["context_dims"] = tuple(args.hidden_dims)
    return ModelConfig(**overrides)


def main(argv=None):
    """Run one evaluator; returns its result dict."""
    args = parse_args(argv)
    if args.restore_ckpt and not os.path.isfile(args.restore_ckpt):
        sys.exit(f"error: checkpoint file not found: {args.restore_ckpt}")
    logging.basicConfig(level=logging.INFO)

    from tcs_tpu_torch import evaluate as ev
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.parallel import mesh
    from tcs_tpu_torch.utils.checkpoint import load_weights

    if args.sharded:
        mesh.initialize_distributed(*mesh.launcher_args(), device=args.device)
    try:
        device = mesh.local_device(args.device)
        cfg = build_model_config(args)
        model = TCStereo(cfg, device=device)
        n = sum(p.numel() for p in model.parameters())
        print(f"The model has {n / 1e6:.2f}M learnable parameters.")
        if args.restore_ckpt:
            load_weights(model, args.restore_ckpt)
            print(f"Loaded checkpoint {args.restore_ckpt}")

        common = dict(iters=args.valid_iters, device=device, sharded=mesh.active())
        if args.dataset == "TartanAir":
            results = ev.validate_tartanair(model, cfg, root=args.data_root,
                                            max_sequences=args.max_sequences, **common)
        elif args.dataset == "things":
            results = ev.validate_temporal_things(model, cfg, root=args.data_root,
                                                  max_sequences=args.max_sequences,
                                                  **common)
        else:
            results = ev.submit_kitti(model, cfg, root=os.path.join(args.data_root, "KITTI"),
                                      **common)
        if mesh.is_primary():
            print(json.dumps(results))
        return results
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()

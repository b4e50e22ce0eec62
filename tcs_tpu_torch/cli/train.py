"""Training CLI of the port (``scripts/train.py``; reference launch scripts
and ``train_stereo.py __main__``).

Examples:
  python -m tcs_tpu_torch.cli.train --recipe sceneflow --data_root /data
  python -m tcs_tpu_torch.cli.train --recipe TartanAir
  python -m tcs_tpu_torch.cli.train --recipe kitti_raw --restore_ckpt tartanair.pth
  python -m torch.distributed.run --nproc_per_node 2 -m tcs_tpu_torch.cli.train \
      --recipe sceneflow

``scripts/train.py``'s flags, less its TPU formulation flags
(``--frame_parallel_backward``, ``--frame_inline_backward``: the port has
one formulation). Data parallelism runs one process per card
(``parallel/mesh.py``): ``--coordinator host:port --num_processes N
--process_id R`` on each, or the environment that ``python -m
torch.distributed.run`` gives its processes when the flags are absent;
``--batch_size`` is per process, as in ``tcs_tpu`` and the reference. Added:
``--validation_frequency`` (the checkpoint cadence, which ``TrainConfig``
has and ``scripts/train.py`` cannot set), ``--device`` ('cuda', the
default, which is each process's own card, or 'cpu') and ``--deterministic``
(cuDNN's deterministic algorithms, ``device.deterministic()``; a trainer
argument, not a ``TrainConfig`` field, so the config stays ``tcs_tpu``'s).
A run that a SIGTERM stops checkpoints and exits 0; the same command resumes
it. On the card the resumed run is sure to retrace the uninterrupted one,
step for step, only where both have ``--deterministic``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--recipe", required=True,
                   choices=["sceneflow", "TartanAir", "kitti_raw"])
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--restore_ckpt", default=None,
                   help="initial weights: a .pth or .npz file, a directory of the "
                        "port's checkpoints, or tcs_tpu's Orbax save_params or "
                        "CheckpointManager directory")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_workers", type=int, default=None,
                   help="loader worker processes (0: load in this process)")
    p.add_argument("--yjitter", action="store_true", default=None,
                   help="±2px right-image row jitter at crop time")
    p.add_argument("--train_dataset", default=None,
                   help="override the recipe's dataset (e.g. 'kitti' for the "
                        "2015+2012 GT fine-tune, 'sintel_stereo+eth3d' mixtures)")
    p.add_argument("--single_frame", action="store_true",
                   help="train single pairs (reference without --temporal): "
                        "sets temporal=False and frame_length=1")
    p.add_argument("--frame_length", type=int, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None, metavar=("H", "W"))
    p.add_argument("--do_flip", default=None, choices=["h", "hf", "v"],
                   help="single-pair flip augmentation")
    p.add_argument("--name", default=None, help="run/checkpoint name")
    p.add_argument("--train_iters", type=int, default=None)
    p.add_argument("--valid_iters", type=int, default=None)
    p.add_argument("--wdecay", type=float, default=None)
    p.add_argument("--init_k", type=int, default=None,
                   help="top-k peaks pushed by the init loss")
    p.add_argument("--spatial_scale", type=float, nargs=2, default=None,
                   metavar=("MIN", "MAX"), help="augmentor random-resize range (log2 factors)")
    p.add_argument("--saturation_range", type=float, nargs=2, default=None,
                   metavar=("MIN", "MAX"))
    p.add_argument("--img_gamma", type=float, nargs=2, default=None, metavar=("MIN", "MAX"))
    p.add_argument("--init_thres", type=float, default=None,
                   help="init-loss margin threshold (ModelConfig.init_thres)")
    p.add_argument("--validation_frequency", type=int, default=None,
                   help="checkpoint (and validate) every this many steps")
    # Architecture choices (reference train_stereo.py:481-487); None keeps the
    # recipe's ModelConfig, and the boolean flags come in pairs, as in
    # scripts/train.py.
    p.add_argument("--corr_levels", type=int, default=None)
    p.add_argument("--corr_radius", type=int, default=None)
    p.add_argument("--n_downsample", type=int, default=None)
    p.add_argument("--n_gru_layers", type=int, default=None)
    p.add_argument("--hidden_dims", type=int, nargs="+", default=None,
                   help="hidden state and context dimensions (sets both)")
    p.add_argument("--context_norm", default=None,
                   choices=["group", "batch", "instance", "none"])
    p.add_argument("--shared_backbone", dest="shared_backbone", action="store_true",
                   default=None)
    p.add_argument("--no_shared_backbone", dest="shared_backbone", action="store_false")
    p.add_argument("--slow_fast_gru", dest="slow_fast_gru", action="store_true", default=None)
    p.add_argument("--mixed_precision", dest="mixed_precision", action="store_true",
                   default=None, help="bf16 conv stacks (fp32 correlation/geometry)")
    p.add_argument("--no_mixed_precision", dest="mixed_precision", action="store_false",
                   help="run everything in fp32")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--validate", action="store_true",
                   help="run the recipe's validation at each checkpoint")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: this process's card) or 'cpu'")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms: on the card exact resume "
                        "is guaranteed only with this flag on the stopped run and on "
                        "its resume (the fp32 step is not reproducible without it); "
                        "its cost is in PERF.md; the CPU's step is deterministic "
                        "without it")
    # data parallelism, one process per card
    p.add_argument("--coordinator", default=None, help="host:port of rank 0's rendezvous")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def process_group_args(args):
    """(coordinator, num_processes, process_id) for
    ``parallel.mesh.initialize_distributed``: the flags, or else the
    launcher's environment, or else (None, None, None), one process."""
    if args.num_processes is not None:
        return args.coordinator, args.num_processes, args.process_id
    from tcs_tpu_torch.parallel import mesh

    return mesh.launcher_args()


def build_config(args):
    """The recipe's ``TrainConfig`` with the flags that were given, as
    ``scripts/train.py``'s ``build_config`` maps them. Pure: no import of
    torch, no side effect."""
    from tcs_tpu_torch.config import RECIPES

    cfg = RECIPES[args.recipe]()
    overrides = {}
    for key in ("data_root", "checkpoint_dir", "restore_ckpt", "num_steps",
                "batch_size", "lr", "num_workers", "yjitter", "train_dataset",
                "frame_length", "do_flip", "name", "train_iters", "valid_iters",
                "wdecay", "init_k", "validation_frequency"):
        v = getattr(args, key)
        if v is not None:
            overrides[key] = v
    for key in ("image_size", "spatial_scale", "saturation_range", "img_gamma"):
        v = getattr(args, key)
        if v is not None:
            overrides[key] = tuple(v)
    model_overrides = {}
    for key in ("corr_levels", "corr_radius", "n_downsample", "n_gru_layers",
                "context_norm", "shared_backbone", "slow_fast_gru",
                "mixed_precision", "init_thres"):
        v = getattr(args, key)
        if v is not None:
            model_overrides[key] = v
    if args.hidden_dims is not None:
        # one flag feeds both the hidden and the context dimensions, as in
        # the reference
        model_overrides["hidden_dims"] = tuple(args.hidden_dims)
        model_overrides["context_dims"] = tuple(args.hidden_dims)
    if model_overrides:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_overrides))
    if args.single_frame:
        overrides["temporal"] = False
        overrides["frame_length"] = 1
    return dataclasses.replace(cfg, **overrides)


def main(argv=None):
    """Train; returns the trainer's stop position."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    cfg = build_config(args)

    from tcs_tpu_torch import evaluate as ev
    from tcs_tpu_torch.parallel import mesh
    from tcs_tpu_torch.train.trainer import Trainer

    mesh.initialize_distributed(*process_group_args(args), device=args.device)
    try:
        trainer = Trainer(cfg, device=args.device, use_wandb=args.wandb,
                          deterministic=args.deterministic)
        validate_fn = None
        if args.validate:
            kw = dict(iters=cfg.valid_iters, root=cfg.data_root, device=trainer.device,
                      metrics_logger=trainer.logger, log_images=2 if args.wandb else 0,
                      sharded=mesh.active())
            if args.recipe == "TartanAir":
                validate_fn = lambda m, c: ev.validate_tartanair(m, c, **kw)  # noqa: E731
            elif args.recipe == "sceneflow":
                validate_fn = lambda m, c: ev.validate_temporal_things(m, c, **kw)  # noqa: E731
        return trainer.train(validate_fn=validate_fn)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()

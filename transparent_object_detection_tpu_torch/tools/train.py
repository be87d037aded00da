"""Training driver: every training setting is a flag, or `--config` loads a
YAML/JSON file with {model, train, predict} sections.

    python -m transparent_object_detection_tpu_torch.tools.train \
        --classes model_data/coco_classes.txt \
        --train-annotations train.txt --val-annotations val.txt [--device cpu]

Data-parallel over every rank of a torchrun launch (one rank a card, NCCL;
each rank steps on its rows of every global batch, rank 0 writes the logs
and checkpoints):

    torchrun --nproc-per-node 4 -m transparent_object_detection_tpu_torch.tools.train \
        ... --data-parallel
"""
from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="YAML/JSON config file")
    p.add_argument("--classes", default="model_data/coco_classes.txt")
    p.add_argument("--phi", default="s", choices=list("nsmlx"))
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--model-path", default=None,
                   help="pretrained weights file (FOCUS.save_weights, best_weights)")
    p.add_argument("--train-annotations", default="train.txt")
    p.add_argument("--val-annotations", default="val.txt")
    p.add_argument("--save-dir", default="logs")
    p.add_argument("--seed", type=int, default=11)
    # schedule
    p.add_argument("--init-epoch", type=int, default=0)
    p.add_argument("--freeze-epoch", type=int, default=50)
    p.add_argument("--unfreeze-epoch", type=int, default=300)
    p.add_argument("--no-freeze-train", action="store_true")
    p.add_argument("--freeze-batch-size", type=int, default=32)
    p.add_argument("--unfreeze-batch-size", type=int, default=16)
    # optimizer
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--init-lr", type=float, default=1e-2)
    p.add_argument("--momentum", type=float, default=0.937)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--lr-decay-type", default="cos", choices=["cos", "step"])
    p.add_argument("--label-smoothing", type=float, default=0.0)
    # augmentation
    p.add_argument("--no-mosaic", action="store_true")
    p.add_argument("--mosaic-prob", type=float, default=0.5)
    p.add_argument("--no-mixup", action="store_true")
    p.add_argument("--mixup-prob", type=float, default=0.5)
    p.add_argument("--special-aug-ratio", type=float, default=0.7)
    # io / eval
    p.add_argument("--save-period", type=int, default=10)
    p.add_argument("--eval-period", type=int, default=10)
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--data-parallel", action="store_true",
                   help="train data-parallel over the ranks of a torchrun launch (the batch "
                        "sizes are global and must divide the number of ranks)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from transparent_object_detection_tpu_torch.api import assign_variables, variables_of
    from transparent_object_detection_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
        load_config,
    )
    from transparent_object_detection_tpu_torch.data.annotations import read_annotation_file
    from transparent_object_detection_tpu_torch.eval.callbacks import EvalCallback, LossHistory
    from transparent_object_detection_tpu_torch.train.checkpoints import (
        CheckpointManager,
        load_weights_partial,
    )
    from transparent_object_detection_tpu_torch.train.trainer import Trainer
    from transparent_object_detection_tpu_torch.utils.common import (
        get_classes,
        seed_everything,
        show_config,
    )

    if args.config:
        model_cfg, train_cfg, _ = load_config(args.config)
        class_names, _ = get_classes(args.classes)
    else:
        class_names, num_classes = get_classes(args.classes)
        model_cfg = ModelConfig(
            num_classes=num_classes,
            phi=args.phi,
            input_shape=tuple(args.input_shape),
            compute_dtype=args.compute_dtype,
        )
        train_cfg = TrainConfig(
            seed=args.seed,
            init_epoch=args.init_epoch,
            freeze_epoch=args.freeze_epoch,
            unfreeze_epoch=args.unfreeze_epoch,
            freeze_train=not args.no_freeze_train,
            freeze_batch_size=args.freeze_batch_size,
            unfreeze_batch_size=args.unfreeze_batch_size,
            init_lr=args.init_lr,
            optimizer_type=args.optimizer,
            momentum=args.momentum,
            weight_decay=args.weight_decay,
            lr_decay_type=args.lr_decay_type,
            label_smoothing=args.label_smoothing,
            ema=not args.no_ema,
            mosaic=not args.no_mosaic,
            mosaic_prob=args.mosaic_prob,
            mixup=not args.no_mixup,
            mixup_prob=args.mixup_prob,
            special_aug_ratio=args.special_aug_ratio,
            save_period=args.save_period,
            save_dir=args.save_dir,
            eval_flag=not args.no_eval,
            eval_period=args.eval_period,
            num_workers=args.num_workers,
            train_annotation_path=args.train_annotations,
            val_annotation_path=args.val_annotations,
        )

    mesh = None
    if args.data_parallel:
        from transparent_object_detection_tpu_torch.parallel import (
            initialize_multihost,
            make_mesh,
            process_index,
        )

        initialize_multihost(device=args.device)  # before anything is made on a card
        mesh = make_mesh()
        if process_index() == 0:
            print(f"data-parallel over {mesh.shape['data']} ranks")

    seed_everything(train_cfg.seed)
    train_lines = read_annotation_file(train_cfg.train_annotation_path)
    val_lines = read_annotation_file(train_cfg.val_annotation_path)
    show_config(
        **{f.name: getattr(train_cfg, f.name) for f in dataclasses.fields(train_cfg)},
        num_train=len(train_lines),
        num_val=len(val_lines),
        phi=model_cfg.phi,
    )

    trainer = Trainer(model_cfg, train_cfg, device=args.device)
    if args.model_path:
        path = os.path.abspath(args.model_path)
        src = CheckpointManager(os.path.dirname(path)).load_tree(path)
        merged, loaded, skipped = load_weights_partial(variables_of(trainer.model), src)
        assign_variables(trainer.model, merged)
        print(f"pretrained: loaded {len(loaded)}, skipped {len(skipped)} tensors")

    callbacks = [
        *([LossHistory(train_cfg.save_dir)] if trainer.is_main else []),  # rank 0 logs
        EvalCallback(model_cfg, val_lines, class_names, train_cfg.save_dir,
                     period=train_cfg.eval_period, eval_flag=train_cfg.eval_flag,
                     device=trainer.device),
    ]
    ckpt = CheckpointManager(train_cfg.save_dir, save_ema=train_cfg.ema)
    trainer.fit(train_lines, val_lines, callbacks=callbacks, checkpointer=ckpt, mesh=mesh)


if __name__ == "__main__":
    main()

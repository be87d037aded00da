"""Training observability callbacks: the port's counterpart of
transparent_object_detection_tpu/eval/callbacks.py.

LossHistory: per-epoch train/val loss -> txt logs, loss-curve PNG, and
TensorBoard scalars (matplotlib and tensorboardX when present, silently
skipped otherwise).

EvalCallback: every `period` epochs, runs the port's batched inference path
(`inference.Predictor.detect_letterboxed`: forward, DFL decode, exact NMS,
unletterbox, on the device) over the validation set with the EMA weights,
and computes both the COCO 12-stat vector (primary) and VOC-style
mAP@MINOVERLAP (secondary), logging epoch_map.txt and a curve PNG. The
weights are given to the forward with `torch.func.functional_call`: the
training weights are not overwritten and the model is left in the mode it
was in.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
from transparent_object_detection_tpu_torch.data.annotations import parse_annotation_line
from transparent_object_detection_tpu_torch.eval.coco_map import coco_eval
from transparent_object_detection_tpu_torch.eval.voc_map import voc_map
from transparent_object_detection_tpu_torch.models.detector import resolve_device


def _plot(xs, series: Dict[str, list], path: str, xlabel: str, ylabel: str):
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        return
    plt.figure()
    for label, ys in series.items():
        plt.plot(xs, ys, linewidth=2, label=label)
    plt.grid(True)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend(loc="upper right")
    plt.savefig(path)
    plt.cla()
    plt.close("all")


class LossHistory:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.losses: List[float] = []
        self.val_losses: List[float] = []
        self.writer = None
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(log_dir)
        except Exception:
            pass

    def on_epoch_end(self, epoch: int, logs: Dict[str, float], trainer=None, state=None):
        if not getattr(trainer, "is_main", True):  # data-parallel: rank 0 writes
            return
        self.append_loss(epoch, logs["loss"], logs["val_loss"])

    def append_loss(self, epoch: int, loss: float, val_loss: float):
        self.losses.append(loss)
        self.val_losses.append(val_loss)
        with open(os.path.join(self.log_dir, "epoch_loss.txt"), "a") as f:
            f.write(f"{loss}\n")
        with open(os.path.join(self.log_dir, "epoch_val_loss.txt"), "a") as f:
            f.write(f"{val_loss}\n")
        if self.writer is not None:
            self.writer.add_scalar("loss", loss, epoch)
            self.writer.add_scalar("val_loss", val_loss, epoch)
        _plot(
            range(len(self.losses)),
            {"train loss": self.losses, "val loss": self.val_losses},
            os.path.join(self.log_dir, "epoch_loss.png"),
            "Epoch",
            "Loss",
        )

    def close(self):
        if self.writer is not None:
            self.writer.close()


class _ModelOn(nn.Module):
    """`model`'s forward in evaluation mode on `variables` ({name: tensor}
    over its parameters and buffers), through `torch.func.functional_call`:
    its own weights are not touched, and its mode is restored after each
    call. The model is held outside the module tree, so the Predictor's
    `.to(device).eval()` on this wrapper leaves it alone."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["wrapped"] = model
        self.variables: Dict[str, torch.Tensor] = {}

    def forward(self, images: torch.Tensor, decode: bool = True):
        model = self.wrapped
        was_training = model.training
        model.eval()
        try:
            return torch.func.functional_call(model, self.variables, (images,),
                                              {"decode": decode})
        finally:
            model.train(was_training)


class EvalCallback:
    """Periodic mAP evaluation on the validation annotations."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        val_lines: Sequence[str],
        class_names: Sequence[str],
        log_dir: str,
        period: int = 1,
        confidence: float = 0.05,
        nms_iou: float = 0.5,
        max_boxes: int = 100,
        min_overlap: float = 0.5,
        batch_size: int = 8,
        eval_flag: bool = True,
        use_ema: bool = True,
        device=None,
    ):
        # the device the evaluation runs on: CUDA unless the caller names
        # another (without a card this raises unless device="cpu")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.val_lines = list(val_lines)
        self.class_names = list(class_names)
        self.log_dir = log_dir
        self.period = max(1, period)
        self.min_overlap = min_overlap
        self.batch_size = batch_size
        self.eval_flag = eval_flag
        self.use_ema = use_ema
        self.maps: List[float] = []
        self.epochs: List[int] = []
        os.makedirs(log_dir, exist_ok=True)
        self.predict_cfg = PredictConfig(
            confidence=confidence,
            nms_iou=nms_iou,
            max_detections=max_boxes,
            nms_mode="exact",
            letterbox_image=True,
        )
        self._predictor = None  # reused across epochs, given fresh weights
        # a data-parallel mesh to evaluate on (every rank of it calls
        # evaluate); on_epoch_end adopts the trainer's
        self.mesh = None
        # populated by evaluate(): per-image (N,6) dets / (M,5) gts, so
        # callers can cache raw detections
        self.last_dets: List[np.ndarray] = []
        self.last_gts: List[np.ndarray] = []

    # -- trainer hook ---------------------------------------------------------

    def on_epoch_end(self, epoch: int, logs: Dict[str, float], trainer=None, state=None):
        """state: the trainer's TrainState (variables: {"params": {name:
        tensor}, "batch_stats": {name: tensor}})."""
        if not self.eval_flag or epoch % self.period != 0:
            return
        if self.use_ema and state is not None:
            variables = {"params": state.ema_params, "batch_stats": state.ema_batch_stats}
        elif state is not None:
            variables = {"params": state.params, "batch_stats": state.batch_stats}
        else:
            variables = trainer.variables
        # under a data-parallel fit every rank evaluates (the Predictor
        # splits each batch over the training mesh); rank 0 writes
        self.mesh = getattr(trainer, "mesh", None)
        stats = self.evaluate(trainer.model, variables)
        map50 = stats["AP50"] if stats["AP50"] >= 0 else stats["voc_map"]
        self.maps.append(float(map50))
        self.epochs.append(epoch)
        logs["map50"] = float(map50)
        logs["coco_ap"] = float(stats["AP"])
        if not getattr(trainer, "is_main", True):
            return
        with open(os.path.join(self.log_dir, "epoch_map.txt"), "a") as f:
            f.write(f"{map50}\n")
        _plot(
            self.epochs,
            {f"mAP@{self.min_overlap}": self.maps},
            os.path.join(self.log_dir, "epoch_map.png"),
            "Epoch",
            "mAP",
        )

    # -- core -------------------------------------------------------------------

    def write_cartucho_dirs(self, dets_all, gts_all, out_root: str) -> None:
        """Dump detection-results/ and ground-truth/ txt dirs in the Cartucho
        format the reference writes (callbacks.py:196-207), for external
        tooling interop."""
        dr = os.path.join(out_root, "detection-results")
        gt = os.path.join(out_root, "ground-truth")
        os.makedirs(dr, exist_ok=True)
        os.makedirs(gt, exist_ok=True)
        for i, (det, g) in enumerate(zip(dets_all, gts_all)):
            with open(os.path.join(dr, f"{i:06d}.txt"), "w") as f:
                for row in det:
                    name = self.class_names[int(row[5])]
                    f.write(f"{name} {row[4]:.6f} {int(row[0])} {int(row[1])} "
                            f"{int(row[2])} {int(row[3])}\n")
            with open(os.path.join(gt, f"{i:06d}.txt"), "w") as f:
                for row in g:
                    name = self.class_names[int(row[4])]
                    f.write(f"{name} {int(row[0])} {int(row[1])} {int(row[2])} "
                            f"{int(row[3])}\n")

    def evaluate(self, model, variables, write_dirs: Optional[str] = None) -> Dict[str, float]:
        """Run batched inference over val_lines with `model`'s graph on
        `variables` ({"params": {name: tensor}, "batch_stats": {name:
        tensor}}) and score with COCO + VOC. Images are decoded and
        letterboxed with PIL on the host, as the Predictor's single-image
        path does; a last batch shorter than batch_size runs at its own size
        (per-image results do not depend on the batch). On a data-parallel
        `self.mesh` (every rank calls this) the Predictor splits each batch
        over the ranks: the batch size is rounded up to a multiple of
        `data_shards` and the last batch is padded to it with blank
        images, whose detections are dropped."""
        from PIL import Image

        from transparent_object_detection_tpu_torch.inference import Predictor
        from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image

        if (self._predictor is None or self._predictor.model.wrapped is not model
                or self._predictor.mesh is not self.mesh):
            self._predictor = Predictor(_ModelOn(model), self.model_cfg, self.predict_cfg,
                                        device=self.device, mesh=self.mesh)
        predictor = self._predictor
        predictor.model.variables = {**variables["params"], **variables["batch_stats"]}
        h, w = self.model_cfg.input_shape
        dets_all: List[np.ndarray] = []
        gts_all: List[np.ndarray] = []
        n_shards = predictor.data_shards
        bs = -(-self.batch_size // n_shards) * n_shards

        for start in range(0, len(self.val_lines), bs):
            chunk = self.val_lines[start : start + bs]
            images, shapes, gts = [], [], []
            for line in chunk:
                path, boxes = parse_annotation_line(line)
                img = cvt_color(Image.open(path))
                iw, ih = img.size
                boxed = resize_image(img, (w, h), letterbox_image=True)
                images.append(np.asarray(boxed, dtype=np.float32) / 255.0)
                shapes.append([ih, iw])
                gts.append(
                    np.concatenate([boxes[:, :4], boxes[:, 4:5]], axis=1)
                    if len(boxes)
                    else np.zeros((0, 5))
                )
            n = len(images)
            if n_shards > 1:  # pad the tail batch to the split batch size
                images += [np.zeros((h, w, 3), np.float32)] * (bs - n)
                shapes += [[h, w]] * (bs - n)
            out = predictor.detect_letterboxed(np.stack(images), np.asarray(shapes, np.float32))
            boxes_np = out["boxes"].float().cpu().numpy()
            scores_np = out["scores"].float().cpu().numpy()
            cls_np = out["classes"].cpu().numpy()
            valid_np = out["valid"].cpu().numpy()
            for i in range(n):
                v = valid_np[i]
                dets_all.append(
                    np.concatenate(
                        [boxes_np[i][v], scores_np[i][v, None], cls_np[i][v, None]], axis=1
                    )
                    if v.any()
                    else np.zeros((0, 6))
                )
                gts_all.append(gts[i])

        if write_dirs:
            self.write_cartucho_dirs(dets_all, gts_all, write_dirs)
        self.last_dets, self.last_gts = dets_all, gts_all
        nc = len(self.class_names)
        coco = coco_eval(dets_all, gts_all, nc)
        vmap, _ = voc_map(dets_all, gts_all, nc, self.min_overlap)
        coco["voc_map"] = vmap
        return coco

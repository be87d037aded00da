"""FOCUS — the object API of the PyTorch port (counterpart of
transparent_object_detection_tpu/api.py): one object that builds the model,
loads and saves its weights, trains, predicts on images, folders and
videos, times, evaluates, exports, fuses and summarizes.

    from transparent_object_detection_tpu_torch import FOCUS
    f = FOCUS(phi="s", classes_path="model_data/coco_classes.txt")  # CUDA
    f.train("dataset/")          # train.txt / val.txt inside
    f.predict("image.jpg")       # extension dispatch
    f.export("model.pt2")        # torch.export program with the kernels' ops

It runs on CUDA unless given `device` (`device="cpu"` runs the kernels'
plain versions). The weights live in `model` (an nn.Module); `variables`
gives them in the JAX package's two collections, {"params": {name:
tensor}, "batch_stats": {name: tensor}}. `serve_mesh` serves on the ranks
of a process group (parallel/): data-parallel, or with the neck TEBs
tensor-parallel.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig, TrainConfig
from transparent_object_detection_tpu_torch.utils.common import (
    get_classes,
    seed_everything,
    show_config,
)

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


class _Decoded(torch.nn.Module):
    """The evaluation forward's `decoded` alone: the program `export` and
    `summary` trace."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)["decoded"]


def variables_of(model: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """A model's weights as the JAX package's two collections: {"params":
    {name: tensor}, "batch_stats": {name: tensor}} (the model's own tensors,
    detached; no copy)."""
    return {"params": {n: p.detach() for n, p in model.named_parameters()},
            "batch_stats": dict(model.named_buffers())}


@torch.no_grad()
def assign_variables(model: torch.nn.Module, variables) -> None:
    """Copy {"params": ..., "batch_stats": ...} (every name of the model)
    into the model, on its device and in its dtypes."""
    for name, p in model.named_parameters():
        p.copy_(torch.as_tensor(variables["params"][name]))
    for name, b in model.named_buffers():
        b.copy_(torch.as_tensor(variables["batch_stats"][name]))


def load_exported(path: str):
    """The program `FOCUS.export` wrote, as a callable module: images (1, h,
    w, 3) float32 in [0, 1] on the device it was exported on -> decoded.
    Importing the port's ops first registers the `focus::` kernels the
    program calls."""
    import transparent_object_detection_tpu_torch.ops  # noqa: F401

    return torch.export.load(path).module()


class FOCUS:
    def __init__(
        self,
        phi: str = "s",
        model_path: Optional[str] = None,
        classes_path: str = "model_data/coco_classes.txt",
        input_shape: Tuple[int, int] = (640, 640),
        compute_dtype: str = "bfloat16",
        int8: bool = False,
        predict_cfg: Optional[PredictConfig] = None,
        seed: int = 11,
        verbose: bool = True,
        device=None,
    ):
        """int8=True serves through the int8 kernels (the TEB projections as
        int8 GEMMs and int8 flash attention); the parameters are the bf16
        model's, so one checkpoint serves both, and training through this
        object always runs the bf16 model. `device`: CUDA unless the caller
        names another; without a card this raises unless device="cpu"."""
        from transparent_object_detection_tpu_torch.models.detector import (
            build_model,
            resolve_device,
        )

        self.device = resolve_device(device)
        self.class_names, self.num_classes = get_classes(classes_path)
        self.model_cfg = ModelConfig(
            num_classes=self.num_classes,
            phi=phi,
            input_shape=tuple(input_shape),
            compute_dtype=compute_dtype,
            int8_dense=int8,
            int8_attn=int8,
        )
        self.predict_cfg = predict_cfg or PredictConfig()
        self.seed = seed
        seed_everything(seed)
        self.model = build_model(self.model_cfg, device=self.device, seed=seed)
        self._predictor = None
        if model_path:
            self.load_weights(model_path)
        if verbose:
            show_config(
                phi=phi,
                model_path=model_path,
                classes_path=classes_path,
                input_shape=self.model_cfg.input_shape,
                num_classes=self.num_classes,
                compute_dtype=compute_dtype,
                backend=self.device.type,
            )

    # ------------------------------------------------------------------ io

    @property
    def variables(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The model's weights (`variables_of`)."""
        return variables_of(self.model)

    def set_variables(self, variables) -> None:
        """Copy {"params": ..., "batch_stats": ...} into the model."""
        assign_variables(self.model, variables)
        self._predictor = None

    def load_weights(self, path: str, partial: bool = True) -> None:
        """Load a weights file of the port's CheckpointManager (`save_weights`,
        the trainer's `best_weights`/`last_weights`), with shape-filtered
        partial semantics: every tensor whose name and shape match loads."""
        from transparent_object_detection_tpu_torch.train.checkpoints import (
            CheckpointManager,
            load_weights_partial,
        )

        path = os.path.abspath(path)
        tree = CheckpointManager(os.path.dirname(path)).load_tree(path)
        if partial:
            merged, loaded, skipped = load_weights_partial(self.variables, tree)
            self.set_variables(merged)
            print(f"loaded {len(loaded)} tensors, skipped {len(skipped)}")
        else:
            self.set_variables(tree)

    def save_weights(self, path: str) -> str:
        from transparent_object_detection_tpu_torch.train.checkpoints import CheckpointManager

        path = os.path.abspath(path)
        return CheckpointManager(os.path.dirname(path)).save_tree(os.path.basename(path),
                                                                  self.variables)

    # ------------------------------------------------------------------ train

    def _annotation_lines(self, dataset_path: str, split: str) -> List[str]:
        """Read {split}.txt inside dataset_path."""
        from transparent_object_detection_tpu_torch.data.annotations import read_annotation_file

        return read_annotation_file(os.path.join(dataset_path, f"{split}.txt"))

    def train(
        self,
        dataset_path: Optional[str] = None,
        train_lines: Optional[Sequence[str]] = None,
        val_lines: Optional[Sequence[str]] = None,
        epochs: int = 100,
        batch_size: int = 16,
        lr: float = 1e-3,
        save_dir: str = "./logs",
        train_cfg: Optional[TrainConfig] = None,
        eval_period: int = 10,
        freeze_train: bool = False,
        num_workers: Optional[int] = None,
    ) -> List[Dict[str, float]]:
        """Train on annotation files (Trainer.fit with LossHistory,
        EvalCallback and a CheckpointManager in save_dir; without train_cfg,
        Adam at `lr`, mosaic and mixup 0.5, EMA, save_period 10), then adopt
        the trained (EMA) weights. `num_workers` overrides the config's loader
        threads."""
        from transparent_object_detection_tpu_torch.eval.callbacks import (
            EvalCallback,
            LossHistory,
        )
        from transparent_object_detection_tpu_torch.train.checkpoints import CheckpointManager
        from transparent_object_detection_tpu_torch.train.trainer import Trainer

        if train_lines is None:
            train_lines = self._annotation_lines(dataset_path, "train")
        if val_lines is None:
            val_lines = self._annotation_lines(dataset_path, "val")
        tc = train_cfg or TrainConfig(
            seed=self.seed,
            init_epoch=0,
            freeze_epoch=0 if not freeze_train else 50,
            unfreeze_epoch=epochs,
            freeze_train=freeze_train,
            freeze_batch_size=batch_size,
            unfreeze_batch_size=batch_size,
            optimizer_type="adam",
            init_lr=lr * 64 / batch_size,  # undoes fit_lr's batch scaling: lr itself
            save_period=10,
            save_dir=save_dir,
            eval_period=eval_period,
        )
        if num_workers is not None:
            tc = dataclasses.replace(tc, num_workers=num_workers)
        cfg = self.model_cfg
        model = self.model
        if cfg.int8_dense or cfg.int8_attn or cfg.int8_1x1:
            # training (its validation and EvalCallback too) runs the bf16
            # model: the int8 projections round, a zero gradient. The
            # parameters are the same, so the trained weights come back into
            # this int8 serving model unchanged.
            cfg = dataclasses.replace(cfg, int8_dense=False, int8_attn=False, int8_1x1=False)
            model = copy.deepcopy(self.model)
            for m in model.modules():
                for flag in ("int8_dense", "int8_attn", "int8_1x1"):
                    if getattr(m, flag, False):
                        setattr(m, flag, False)
        trainer = Trainer(cfg, tc, model=model, device=self.device)
        callbacks = [
            LossHistory(save_dir),
            EvalCallback(self.model_cfg, val_lines, self.class_names, save_dir,
                         period=tc.eval_period, eval_flag=tc.eval_flag, device=self.device),
        ]
        ckpt = CheckpointManager(save_dir, save_ema=tc.ema)
        history = trainer.fit(train_lines, val_lines, callbacks=callbacks, checkpointer=ckpt)
        self.set_variables(trainer.ema_variables if tc.ema else trainer.variables)
        self.model.eval()
        return history

    def fine_tune(self, dataset_path: Optional[str] = None, epochs: int = 50,
                  lr: float = 1e-4, **kwargs) -> List[Dict[str, float]]:
        """Lower-lr short schedule."""
        return self.train(dataset_path=dataset_path, epochs=epochs, lr=lr, **kwargs)

    # ------------------------------------------------------------------ predict

    @property
    def predictor(self):
        if self._predictor is None:
            from transparent_object_detection_tpu_torch.inference import Predictor

            self._predictor = Predictor(self.model, self.model_cfg, self.predict_cfg,
                                        device=self.device)
        return self._predictor

    def serve_mesh(self, devices=None, axis_name: str = "data", tp: int = 1):
        """Switch serving to a mesh of ranks (every rank of a torchrun launch
        makes this call, after `parallel.initialize_multihost()`; `devices`
        names ranks, None every rank of the world).

        tp=1: a 1-D mesh on `axis_name`: data parallelism, the weights
        replicated, each call's batch split over the ranks and the results
        gathered on each. tp>1: a (data, model) mesh with a tp-way model axis:
        the neck TEBs run Megatron tensor-parallel (ops/teb_tp.py) on the
        Predictor's own sharded copy of the weights; batch sizes must divide
        the data axis (ranks / tp).

        Returns the mesh-aware Predictor."""
        from transparent_object_detection_tpu_torch.inference import Predictor
        from transparent_object_detection_tpu_torch.parallel.mesh import make_mesh
        from transparent_object_detection_tpu_torch.parallel.tp import make_2d_mesh

        mesh = make_2d_mesh(tp, devices) if tp > 1 else make_mesh(devices, axis_name)
        self._predictor = Predictor(self.model, self.model_cfg, self.predict_cfg,
                                    device=self.device, mesh=mesh)
        return self._predictor

    def predict(self, source: str, **kwargs):
        """Extension dispatch: image file -> detections, video file ->
        annotated video, directory -> batch predict."""
        ext = os.path.splitext(source)[1].lower()
        if os.path.isdir(source):
            return self.predict_dir(source, **kwargs)
        if ext in IMAGE_EXTS:
            return self.predict_image(source, **kwargs)
        if ext in VIDEO_EXTS:
            return self.predict_video(source, **kwargs)
        raise ValueError(f"unsupported source {source!r}")

    def detect_image(self, image, draw: bool = False, crop: bool = False,
                     count: bool = False, crop_dir: str = "img_crop"):
        """PIL image (or path) -> detections [{box, score, class}] in original
        pixels; with draw, (detections, annotated image). crop saves each
        detection's pixels under crop_dir; count prints per-class counts."""
        from PIL import Image

        if isinstance(image, str):
            image = Image.open(image)
        rows = self.predictor.predict_image(image)
        if count:
            tally: Dict[str, int] = {}
            for r in rows:
                name = self.class_names[r["class"]]
                tally[name] = tally.get(name, 0) + 1
            print("class counts:", tally or "{}")
        if crop and rows:
            os.makedirs(crop_dir, exist_ok=True)
            rgb = image.convert("RGB")
            for i, r in enumerate(rows):
                x1, y1, x2, y2 = (int(max(v, 0)) for v in r["box"])
                rgb.crop((x1, y1, x2, y2)).save(os.path.join(crop_dir, f"crop_{i}.png"))
        if draw:
            return rows, self.draw_detections(image, rows)
        return rows

    predict_image = detect_image

    def draw_detections(self, image, rows: List[Dict[str, Any]]):
        from PIL import ImageDraw

        img = image.convert("RGB").copy()
        d = ImageDraw.Draw(img)
        for r in rows:
            x1, y1, x2, y2 = r["box"]
            name = self.class_names[r["class"]] if r["class"] < len(self.class_names) else "?"
            d.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)
            d.text((x1 + 2, max(y1 - 12, 0)), f"{name} {r['score']:.2f}", fill=(255, 0, 0))
        return img

    def predict_dir(self, dir_in: str, dir_out: Optional[str] = None,
                    batch_size: int = 8) -> Dict[str, List[Dict[str, Any]]]:
        """Folder prediction, one image at a time through the Predictor;
        optionally writes annotated images to dir_out."""
        from PIL import Image

        paths = sorted(
            os.path.join(dir_in, f)
            for f in os.listdir(dir_in)
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS
        )
        results: Dict[str, List[Dict[str, Any]]] = {}
        for p in paths:
            img = Image.open(p)
            rows = self.predictor.predict_image(img)
            results[p] = rows
            if dir_out:
                os.makedirs(dir_out, exist_ok=True)
                self.draw_detections(img, rows).save(os.path.join(dir_out, os.path.basename(p)))
        return results

    def predict_video(self, source, output_path: Optional[str] = None,
                      max_frames: Optional[int] = None) -> float:
        """Video (or camera index) loop with an FPS overlay; writes the
        annotated frames to output_path. Returns the running FPS."""
        import cv2
        from PIL import Image

        cap = cv2.VideoCapture(int(source) if str(source).isdigit() else source)
        if not cap.isOpened():
            raise IOError("failed to open video source")
        writer = None
        if output_path:
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            fps_in = cap.get(cv2.CAP_PROP_FPS) or 25.0
            size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            writer = cv2.VideoWriter(output_path, fourcc, fps_in, size)
        fps, n = 0.0, 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok or (max_frames is not None and n >= max_frames):
                    break
                t0 = time.time()
                rows = self.predictor.predict_image(
                    Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
                now = 1.0 / max(time.time() - t0, 1e-6)
                fps = 0.9 * fps + 0.1 * now if n else now
                n += 1
                for r in rows:
                    x1, y1, x2, y2 = map(int, r["box"])
                    cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 0, 255), 2)
                    cv2.putText(frame, f"{self.class_names[r['class']]} {r['score']:.2f}",
                                (x1, max(y1 - 5, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                                (0, 0, 255), 1)
                cv2.putText(frame, f"fps = {fps:.2f}", (10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                            (0, 255, 0), 2)
                if writer is not None:
                    writer.write(frame)
        finally:
            cap.release()
            if writer is not None:
                writer.release()
        return fps

    def _letterboxed(self, image) -> Tuple[Any, np.ndarray]:
        """(letterboxed PIL image, float32 (h, w, 3) in [0, 1])."""
        from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image

        h, w = self.model_cfg.input_shape
        boxed = resize_image(cvt_color(image), (w, h), True)
        return boxed, np.asarray(boxed, np.float32) / 255.0

    def get_fps(self, image=None, test_interval: int = 100, batch_size: int = 1) -> float:
        """Mean seconds per detection call of `batch_size` letterboxed images
        over test_interval calls enqueued back to back, ending in one read of
        the detection counts on the host. Two calls outside the timed loop
        warm up: on CUDA the first runs eagerly and the second captures the
        shape's CUDA graph, so the loop times replays, as JAX's times its
        compiled program."""
        from PIL import Image

        if image is None:
            image = Image.new("RGB", self.model_cfg.input_shape[::-1], (128, 128, 128))
        h, w = self.model_cfg.input_shape
        arr = torch.from_numpy(np.tile(self._letterboxed(image)[1][None], (batch_size, 1, 1, 1)))
        arr = arr.to(self.device)
        shapes = torch.tensor([[h, w]] * batch_size, dtype=torch.float32, device=self.device)
        for _ in range(2):
            dets = self.predictor.detect_letterboxed(arr, shapes)
        float(dets["num_detections"].sum())
        t0 = time.time()
        for _ in range(test_interval):
            dets = self.predictor.detect_letterboxed(arr, shapes)
        float(dets["num_detections"].sum())
        return (time.time() - t0) / test_interval

    def detect_heatmap(self, image, out_path: Optional[str] = None) -> np.ndarray:
        """Class-activation heatmap (max class probability at stride 8);
        with out_path also a plot over the letterboxed image, where
        matplotlib is installed."""
        from PIL import Image

        if isinstance(image, str):
            image = Image.open(image)
        h, w = self.model_cfg.input_shape
        boxed, arr = self._letterboxed(image)
        heat = self.predictor.class_activation_map(arr[None])[0].float().cpu().numpy()
        if out_path:
            try:
                import matplotlib

                matplotlib.use("Agg")
                from matplotlib import pyplot as plt

                plt.figure()
                plt.imshow(boxed)
                plt.imshow(np.kron(heat, np.ones((8, 8))), alpha=0.5, cmap="jet",
                           extent=(0, w, h, 0))
                plt.axis("off")
                plt.savefig(out_path, bbox_inches="tight")
                plt.close("all")
            except Exception:  # noqa: BLE001 - the plot is optional; the map is returned
                pass
        return heat

    # ------------------------------------------------------------------ eval / export

    def evaluate(self, val_lines: Sequence[str], batch_size: int = 8,
                 confidence: float = 0.001, nms_iou: float = 0.65) -> Dict[str, float]:
        """Standalone COCO and VOC evaluation of the current weights."""
        from transparent_object_detection_tpu_torch.eval.callbacks import EvalCallback

        cb = EvalCallback(self.model_cfg, val_lines, self.class_names, log_dir=".",
                          confidence=confidence, nms_iou=nms_iou, batch_size=batch_size,
                          device=self.device)
        return cb.evaluate(self.model, self.variables)

    def export(self, path: str) -> str:
        """Write the evaluation forward's `decoded` on (1, h, w, 3) float32
        images as a `torch.export` program (`torch.export.save`; a .pt2
        file). On CUDA the program calls the hand-written kernels as the
        registered `focus::` operators; `load_exported` loads it."""
        h, w = self.model_cfg.input_shape
        example = torch.zeros((1, h, w, 3), dtype=torch.float32, device=self.device)
        self.model.eval()
        with torch.no_grad():
            program = torch.export.export(_Decoded(self.model), (example,))
        torch.export.save(program, path)
        return path

    export_onnx = export  # the reference's capability name

    def fuse(self) -> "FOCUS":
        """Fold each BatchNorm into its conv for deployment
        (`models.blocks.fuse_conv_bn` on the state_dict)."""
        from transparent_object_detection_tpu_torch.models.blocks import fuse_conv_bn

        self.model.load_state_dict(fuse_conv_bn(self.model.state_dict()))
        self._predictor = None
        return self

    def summary(self, batch_size: int = 1) -> Dict[str, float]:
        """Parameter count, and FLOPs and bytes of the evaluation forward at
        `batch_size` (`utils.profiling.cost_analysis`: counted from shapes,
        nothing computed)."""
        from transparent_object_detection_tpu_torch.models.detector import count_params
        from transparent_object_detection_tpu_torch.utils.profiling import cost_analysis

        h, w = self.model_cfg.input_shape
        self.model.eval()
        cost = cost_analysis(_Decoded(self.model),
                             torch.zeros((batch_size, h, w, 3), device=self.device))
        out = {"params": count_params(self.model), **cost}
        print(f"params: {out['params'] / 1e6:.2f}M  "
              f"flops: {out['flops'] / 1e9:.2f}G (batch {batch_size})")
        return out

"""Serving front end of the port (counterpart of
transparent_object_detection_tpu/inference.py):

    device letterbox -> FocusModel forward -> DFL decode -> batched NMS ->
    unletterbox

All of it runs on the Predictor's device, and nothing is read back to the
host between preprocessing and final detections: the only transfers are
the input batch and the fixed-shape detection struct (the exact NMS is one
kernel whose loop is bounded on the device, ops/nms.py).

On CUDA each entry (`detect_letterboxed`, `detect_raw_batch`,
`class_activation_map`) runs as one captured CUDA graph per batch shape,
the counterpart of the JAX Predictor's one compiled XLA program per batch
shape (JAX `_jitted`), with no mesh or on a mesh whose collectives NCCL
runs (parallel/mesh.py `Mesh.capturable`). The graphs live in a
process-wide cache keyed on everything a call reads while it is traced:
the model object (held weakly: its graphs go with it), the entry,
`input_shape`, `predict_cfg`, the mesh's layout, each input's shape and
dtype, and each module's kernel switch (`set_attention_impl`), int8
variants, compute dtype, mode and data shards, so two Predictors on one
model, config and mesh share one graph. The
first call of a key runs eagerly: the warm-up a capture needs (kernel
builds, shared-memory attributes, cuBLAS and cuDNN first use, the int8
weight caches). The second call captures and replays; later calls copy
their inputs into the graph's static buffers and replay. Outputs are
cloned, so a later call never overwrites an earlier result.

A graph reads the weights at replay, so weights updated in place (an
optimizer or EMA step, `FOCUS.fuse`'s load_state_dict) are seen. A graph
reads the tensors it was captured on, so every call compares the
`data_ptr()`s of the model's parameters and buffers (and of a wrapper's
`variables`, eval/callbacks.py's _ModelOn) with those the graph was
captured on; where one differs (`.to()`, `load_state_dict(assign=True)`,
an EvalCallback's new variables), the call runs eagerly again and the next
one captures anew. A model with int8 weight caches (made once from the
weights, outside the graph: models/blocks.py `_cached`) also compares the
tensors' versions, so an in-place update there is a new warm-up too. What
the key reads of the modules is models/detector.py's TRACED_ATTRS.

A capture's memory pool takes more than its eager call (PERF.md), so a
batch whose graph is predicted not to fit beside what the card holds (phi
'l' at batch 32) is captured at a part of it and replayed over its equal
parts, the int8 1x1 convs gated on the whole batch's rows as eagerly.

The same cache holds train/trainer.py's train and eval steps (entries
"trainer.train_step" and "trainer.eval_step", the counterpart of JAX's two
`jax.jit`s), in the model's record and pool. Their fingerprint adds the
tensors they read and write beside the model (gradients, optimizer state,
EMA shadows, counter); a train step's warm-up runs on a side stream, its
batch is never split, and a key whose graph is predicted not to fit runs
eagerly instead.

A failed capture raises; nothing falls back to eager. On the CPU, and on a
mesh with a gloo group (gloo stages its transfers through the host, which a
capture cannot record), the Predictor runs eagerly. The kernels' launch
counters move where a wrapper launches its kernel, eagerly or into a graph
being captured; a replay runs no wrapper, and `programs_of` counts the
replays and the calls answered by them alone.

On a mesh (parallel/) every rank is handed the global batch, as the JAX
caller hands one global array: each data index runs its rows, and the
fixed-shape results are all-gathered over the data axis, so every rank
returns the global result. With a model axis the neck TEBs run tensor-
parallel on the Predictor's own sharded copy of the weights. On NCCL the
whole call (this rank's rows, the step, the all-gather) is one graph, whose
replay launches the collectives. Every rank must launch each collective
once a call in the same order, so the ranks take each decision alike: a
key's first call (eager: it makes every NCCL communicator the graph uses)
ends in one all-reduce of the ranks' warm-up peaks and free bytes, and the
capture and the number of parts are decided from the largest peak and the
least free memory of the mesh.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
from transparent_object_detection_tpu_torch.models.blocks import global_rows
from transparent_object_detection_tpu_torch.models.detector import (
    FocusModel,
    TracedModules,
    resolve_device,
)
from transparent_object_detection_tpu_torch.ops.geometry import xywh2xyxy
from transparent_object_detection_tpu_torch.ops.nms import batched_nms
from transparent_object_detection_tpu_torch.ops.preprocess import (
    letterbox_batch,
    unletterbox_boxes,
)
from transparent_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    replicate_state,
    rows_of,
)
from transparent_object_detection_tpu_torch.parallel.tp import MODEL_AXIS, tp_serving_copy


def detect_step(model: FocusModel, images: torch.Tensor, image_shapes: torch.Tensor,
                input_shape: Tuple[int, int], predict_cfg: PredictConfig) -> Dict[str, torch.Tensor]:
    """Detection on already-letterboxed images.

    images (B, h, w, 3) float in [0, 1] with (h, w) == input_shape;
    image_shapes (B, 2) original (h, w) per image. Returns the batched_nms
    dict with boxes in original-image pixels."""
    decoded = model(images)["decoded"]
    dets = batched_nms(
        xywh2xyxy(decoded[..., :4]),
        decoded[..., 4:],
        conf_thres=predict_cfg.confidence,
        iou_thres=predict_cfg.nms_iou,
        max_detections=predict_cfg.max_detections,
        pre_nms_topk=predict_cfg.pre_nms_topk,
        mode=predict_cfg.nms_mode,
        class_agnostic=predict_cfg.class_agnostic,
    )
    dets["boxes"] = unletterbox_boxes(dets["boxes"], input_shape, image_shapes,
                                      predict_cfg.letterbox_image)
    return dets


def raw_detect_step(model: FocusModel, raw_images: torch.Tensor, image_shapes: torch.Tensor,
                    input_shape: Tuple[int, int],
                    predict_cfg: PredictConfig) -> Dict[str, torch.Tensor]:
    """`detect_step` on a uniform-size batch (B, H, W, 3) of 0-255 pixels,
    letterboxed on the device first (JAX `_letterbox_detect_step`)."""
    images = letterbox_batch(raw_images.float() / 255.0, input_shape)
    return detect_step(model, images, image_shapes, input_shape, predict_cfg)


def cam_step(model: FocusModel, images: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Max class-probability heatmap (B, H/8, W/8) of letterboxed images."""
    raw = model(images, decode=False)["raw"]
    return torch.sigmoid(raw[0][..., 4 * reg_max:].float()).amax(dim=-1)


# ---------------------------------------------------------------------------
# the program cache: one captured CUDA graph per key
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Program:
    """One key's entry: the fingerprint of the tensors it was warmed up or
    captured on (models.detector.TracedModules.fingerprint, and the pointers
    of the step's own tensors), its warm-up's peak bytes above the memory
    allocated before it and the bytes free after it (on a mesh the largest
    peak and the least free bytes of its ranks); once captured, the number
    of equal parts a call's batch runs in (1 unless the whole batch's graph
    would not fit), the graph of one part, its static input buffers and output, the capture's
    seconds and the bytes the graph pool grew by. A training key whose
    graph is predicted not to fit is not captured: `eager` is set, with the
    bytes predicted, and its calls run eagerly.
    The key's counts go on across its captures: the graphs' replays, and
    the calls answered by replays alone (no wrapper ran in them)."""

    fingerprint: tuple
    peak_bytes: int = 0
    parts: int = 1
    graph: Any = None
    inputs: Tuple[torch.Tensor, ...] = ()
    output: Any = None
    capture_s: float = 0.0
    pool_bytes: int = 0
    replays: int = 0
    replayed_calls: int = 0
    eager: bool = False
    predicted_bytes: int = 0
    free_bytes: int = 0


@dataclasses.dataclass
class _Served:
    """A model's record in the program cache: its programs by key, the memory
    pool its graphs share and its flattened modules."""

    programs: Dict[tuple, Program] = dataclasses.field(default_factory=dict)
    pool: Any = None
    modules: Optional[TracedModules] = None


_SERVED: "weakref.WeakKeyDictionary[nn.Module, _Served]" = weakref.WeakKeyDictionary()

# the bytes a captured graph's pool takes, as a multiple of its eager call's
# peak above the memory allocated before it: measured 1.24-1.50 at phi 's'
# and 'l' (kernels/time_serving.py --graphs; PERF.md), the cause not measured
GRAPH_POOL_OVER_EAGER = 1.6


def _traced(model: nn.Module) -> Tuple[_Served, TracedModules]:
    served = _SERVED.get(model)
    if served is None:
        served = _SERVED[model] = _Served()
    if served.modules is None or not served.modules.current():
        served.modules = TracedModules(model)
    return served, served.modules


_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _warm_up(step: Callable, model: nn.Module, inputs: Tuple[torch.Tensor, ...],
             side_stream: bool = False):
    """`step(model, *inputs)` eagerly: (its output, its peak bytes above the
    memory allocated before it; 0 off CUDA). It resets the card's peak
    memory statistic. With `side_stream` (a step with a backward, as
    PyTorch's whole-network capture recipe asks) it runs on a side stream
    that waits for the current one, which then waits for it: one stream a
    device, so that the blocks a warm-up frees (cached by the allocator for
    their stream) serve the next warm-up."""
    device = inputs[0].device
    if device.type != "cuda":
        return step(model, *inputs), 0
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    if side_stream:
        current = torch.cuda.current_stream(device)
        side = _SIDE_STREAMS.get(current.device)
        if side is None:
            side = _SIDE_STREAMS[current.device] = torch.cuda.Stream(current.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = step(model, *inputs)
        current.wait_stream(side)
    else:
        out = step(model, *inputs)
    return out, torch.cuda.max_memory_allocated(device) - before


def _free_bytes(device: torch.device) -> int:
    """What a capture on `device` may take: the card's free memory and the
    allocator's cached blocks (a capture empties the cache first)."""
    if device.type != "cuda":
        return 1 << 62
    return (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _parts(batch: int, peak_bytes: int, free: int, unit: int = 1) -> Optional[int]:
    """The fewest equal parts of `batch` whose graph is predicted to fit in
    `free` bytes (GRAPH_POOL_OVER_EAGER times its share of the whole
    batch's peak), each part a multiple of `unit` rows (a mesh's data
    shards). With one-row units, one row a part when nothing fits; with
    larger units, None when no part fits (the key then runs eagerly)."""
    return next((n for n in range(1, batch + 1)
                 if batch % n == 0 and (batch // n) % unit == 0
                 and (GRAPH_POOL_OVER_EAGER * peak_bytes / n <= free
                      or n == batch)), None)


def _agreed(mesh: Optional[Mesh], peak_bytes: int, free: int, device) -> Tuple[int, int]:
    """The largest warm-up peak and the least free bytes over the ranks of
    `mesh` (one eager all-reduce), so that every rank decides alike; this
    rank's own without a process group."""
    if mesh is None or not mesh.distributed:
        return peak_bytes, free
    t = torch.tensor([-peak_bytes, free], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group_all)
    neg_peak, least = t.tolist()
    return -neg_peak, least


def _pool(served: _Served):
    """The memory pool of a model's graphs: one handle while any of its
    graphs lives, a new one once none does. PyTorch refuses a capture into
    a pool whose graphs are all gone while it still holds a block (an
    allocation made during a capture and kept past it: seen when an
    EvalCallback's new variables replaced the process's first graph)."""
    if served.pool is None or all(p.graph is None for p in served.programs.values()):
        served.pool = torch.cuda.graph_pool_handle()
    return served.pool


def _capture_graph(step: Callable, model: nn.Module, inputs: Tuple[torch.Tensor, ...]):
    """Capture `step(model, *inputs)` into a CUDA graph in the model's
    memory pool: (graph, static output, bytes the pool grew by). One pool
    serves all of a model's graphs, so it holds the largest shape's
    intermediates rather than the sum of its shapes' (phi='l'). That is
    safe because replays run one after another on one stream, inputs are
    copied in before a replay and outputs cloned out after it: no graph
    reads another's intermediates. Captured with
    capture_error_mode="thread_local", so that other threads (the fit's
    loader threads) may call CUDA meanwhile."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_pool(_SERVED[model]), capture_error_mode="thread_local"):
        reserved = torch.cuda.memory_reserved()  # after the context emptied the cache
        out = step(model, *inputs)
    return graph, out, torch.cuda.memory_reserved() - reserved


def _cloned(out):
    return {k: v.clone() for k, v in out.items()} if isinstance(out, dict) else out.clone()


def _replayed(prog: Program, inputs: Tuple[torch.Tensor, ...]):
    """The program's graph replayed on each of its parts of `inputs` (copied
    into its static buffers; a 0-d input, a train step's lr, whole), the
    outputs cloned out and joined."""
    rows = prog.inputs[0].shape[0]
    outs = []
    for i in range(prog.parts):
        for buf, t in zip(prog.inputs, inputs):
            buf.copy_(t if prog.parts == 1 else t[i * rows:(i + 1) * rows])
        prog.graph.replay()
        prog.replays += 1
        outs.append(_cloned(prog.output))
    if prog.parts == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return torch.cat(outs)


def run_program(model: nn.Module, entry: str, step: Callable, inputs: Tuple[torch.Tensor, ...],
                key: tuple, tensors: Callable[[], Tuple[torch.Tensor, ...]] = tuple,
                training: bool = False, mesh: Optional[Mesh] = None):
    """`step(model, *inputs)` through the program cache (inputs on the
    model's device, batch first): eagerly on a key's first call and after
    any tensor it reads changed, captured on the next call, replayed after
    that. A batch whose graph is predicted not to fit beside what the card
    holds runs as replays of one graph over equal parts of it (`_parts`),
    the int8 1x1 convs gated on the whole batch's rows, as eagerly.

    `mesh`: the mesh whose collectives the step issues (a `capturable`
    one: NCCL, or none). Its layout joins the key; the first call of a key
    agrees the memory decision over its ranks (`_agreed`), and a serving
    batch is split only into parts that each divide its data axis, else
    the key runs eagerly. Every rank must make the same calls and change
    the same tensors, so that each takes the same path.

    `tensors()`: what the step reads or writes besides the model's
    parameters and buffers (a train step's gradients, optimizer state, EMA
    shadows and counter); their pointers join the fingerprint, so a
    replaced one warms up and captures anew. `training` (a step with a
    backward): the warm-up runs on a side stream; the batch is never split
    (BatchNorm's batch statistics are the whole batch's), and a key whose
    graph is predicted not to fit (GRAPH_POOL_OVER_EAGER times the warm-up's
    peak against the free bytes) runs eagerly on every call until its
    tensors change, the decision kept in its Program. The step must have no
    host-side effect: a capture runs its Python once without its work, and
    a replay runs no Python."""
    served, modules = _traced(model)
    key = (entry, _program_key(key, mesh), modules.traced(),
           tuple((tuple(t.shape), t.dtype) for t in inputs))
    fingerprint = lambda: modules.fingerprint() + tuple(t.data_ptr() for t in tensors())
    prog = served.programs.get(key)
    if prog is None or prog.fingerprint != fingerprint():
        out, peak = _warm_up(step, model, inputs, training)
        # the memory the capture may take, read now: on a mesh agreed over
        # the ranks in this eager call, never inside a capture
        peak, free = _agreed(mesh, peak, _free_bytes(inputs[0].device), inputs[0].device)
        # the fingerprint after the warm-up: it made the int8 weight caches
        served.programs[key] = Program(fingerprint(), peak, free_bytes=free,
                                       replays=prog.replays if prog else 0,
                                       replayed_calls=prog.replayed_calls if prog else 0)
        return out
    if prog.eager:
        return step(model, *inputs)
    if prog.graph is None:
        batch, free = inputs[0].shape[0], prog.free_bytes
        if training:
            prog.predicted_bytes = int(GRAPH_POOL_OVER_EAGER * prog.peak_bytes)
            if prog.predicted_bytes > free:
                prog.eager = True
                return step(model, *inputs)
            parts = 1
        else:
            parts = _parts(batch, prog.peak_bytes, free,
                           1 if mesh is None else mesh.size(DATA_AXIS))
            if parts is None:  # not even a part of one row a rank fits
                unit = mesh.size(DATA_AXIS)
                prog.predicted_bytes = int(GRAPH_POOL_OVER_EAGER * prog.peak_bytes * unit / batch)
                prog.eager = True
                return step(model, *inputs)
        static = tuple((t if parts == 1 else t[:batch // parts]).clone() for t in inputs)
        t0 = time.perf_counter()
        try:
            with global_rows(nn.ModuleList([model, *modules.wrapped]), parts):
                if parts > 1:  # a warm-up at the part's shape
                    step(model, *static)
                graph, out, grown = _capture_graph(step, model, static)
        except Exception as e:
            del served.programs[key]
            owner = "" if "." in entry else "Predictor."  # the train steps' are "trainer.*"
            raise RuntimeError(f"CUDA graph capture of {owner}{entry} failed") from e
        prog.graph, prog.inputs, prog.output, prog.parts = graph, static, out, parts
        prog.capture_s, prog.pool_bytes = time.perf_counter() - t0, grown
    else:
        prog.replayed_calls += 1
    return _replayed(prog, inputs)


def _program_key(key: tuple, mesh: Optional[Mesh]) -> tuple:
    """The caller's key, with the mesh's layout where there is a mesh (a
    mesh program issues collectives a program without one lacks)."""
    return key if mesh is None else (*key, ("mesh", mesh.layout))


def release_programs(model: nn.Module) -> None:
    """Drop `model`'s graphs and their memory pool (the pool's memory goes
    back to the allocator; `torch.cuda.empty_cache()` returns it to the
    card): each key's next call runs eagerly again. A model's graphs go with
    the model in any case; this is for a model that outlives its serving."""
    _SERVED.pop(model, None)


def programs_of(model: nn.Module) -> List[Dict[str, Any]]:
    """The program cache's entries of `model`: entry, key, whether it is
    captured, the parts a call runs in, capture seconds, pool bytes grown at
    capture, the warm-up's peak bytes, the graphs' replays and the calls
    answered by replays alone; whether the key runs eagerly for want of
    memory (a training key, or a mesh serving key with no part that
    fits), with the bytes predicted and those free after the warm-up."""
    served = _SERVED.get(model)
    return [{"entry": key[0], "key": key, "captured": p.graph is not None, "parts": p.parts,
             "capture_s": p.capture_s, "pool_bytes": p.pool_bytes,
             "peak_bytes": p.peak_bytes, "replays": p.replays,
             "replayed_calls": p.replayed_calls, "eager": p.eager,
             "predicted_bytes": p.predicted_bytes, "free_bytes": p.free_bytes}
            for key, p in (served.programs.items() if served else ())]


def _rows(arrays, mesh: Optional[Mesh]):
    """This rank's rows of each global batch array."""
    return arrays if mesh is None else tuple(rows_of(a, mesh) for a in arrays)


def _gathered(out, mesh: Optional[Mesh]):
    """The global result: each tensor's rows from every data rank."""
    if mesh is None:
        return out
    if isinstance(out, torch.Tensor):
        return all_gather_cat(out, mesh, DATA_AXIS, 0)
    return {k: all_gather_cat(v, mesh, DATA_AXIS, 0) for k, v in out.items()}


class Predictor:
    """Batch detector front end on one device (CUDA unless `device` names
    another).

    On CUDA every call runs through the program cache above: one captured
    CUDA graph per batch shape, the first call of a shape eager, a failed
    capture raising; on a mesh too where its collectives go through NCCL
    (`Mesh.capturable`). On the CPU, and on a mesh with a gloo group, calls
    run eagerly.

    mesh: an optional `parallel.Mesh` (`make_mesh`, `make_2d_mesh`) this
    process is a rank of. The mesh's first rank's weights are broadcast to
    every rank (one replicated copy, as JAX places it); each call takes the
    global batch, runs this rank's rows of it (batch sizes must be a
    multiple of `data_shards`, else ValueError) and returns the global
    result, all-gathered over the data axis. A mesh with a model axis of
    tp > 1 serves tensor-parallel: `model` becomes the Predictor's own copy
    (`parallel.tp.tp_serving_copy`: this rank's shards of the TEB
    projections and of the big kernels, qkv rows canonicalized, weights of
    two or more dimensions in the compute type), the caller's model left as
    it was. The int8 1x1 convs gate on the global batch's rows, as JAX's do
    on its global array (`blocks.global_rows`). Every rank of the mesh
    makes the same calls in the same order. On NCCL a call is one captured
    graph: this rank's rows, the step and the all-gather, keyed on the
    mesh's layout as JAX's `_jitted` keys its mesh; on gloo, whose
    host-staged transfers a CUDA graph cannot capture, calls run
    eagerly."""

    def __init__(self, model: FocusModel, model_cfg: ModelConfig,
                 predict_cfg: Optional[PredictConfig] = None, device=None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        model = model.to(self.device)
        if mesh is not None:
            replicate_state(model, mesh)
            if mesh.size(MODEL_AXIS) > 1:
                model = tp_serving_copy(model, mesh)
        self.model = model.eval()
        self.model_cfg = model_cfg
        self.predict_cfg = predict_cfg or PredictConfig()
        self._graphs = self.device.type == "cuda" and (mesh is None or mesh.capturable)

    @property
    def data_shards(self) -> int:
        """Size of the data axis the Predictor splits a batch over (1 with no
        mesh). Batch sizes must be a multiple of it; callers that batch
        lists of any length (EvalCallback) pad to it."""
        return 1 if self.mesh is None else self.mesh.size(DATA_AXIS)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype=dtype)

    def _call(self, entry: str, step: Callable, inputs: Tuple[torch.Tensor, ...], key: tuple):
        """step(model, *inputs, *key) on this rank's rows of the global
        batch, all-gathered over the data axis: through the program cache
        where the Predictor captures (one program, collectives included),
        else eagerly. The program holds no reference to the Predictor or
        its model (a graph holds no Python object)."""
        mesh, shards = self.mesh, self.data_shards
        if shards > 1 and inputs[0].shape[0] % shards:
            raise ValueError(
                f"batch size {inputs[0].shape[0]} does not divide the mesh data axis ({shards}); "
                f"pad the batch to a multiple of Predictor.data_shards")

        def body(model, *t):
            with global_rows(model, shards):
                return _gathered(step(model, *_rows(t, mesh), *key), mesh)

        if self._graphs:
            return run_program(self.model, entry, body, inputs, key, mesh=mesh)
        return body(self.model, *inputs)

    @torch.inference_mode()
    def detect_letterboxed(self, images, image_shapes) -> Dict[str, torch.Tensor]:
        """images already letterboxed to input_shape, float32 in [0, 1]."""
        inputs = (self._tensor(images, torch.float32), self._tensor(image_shapes, torch.float32))
        return self._call("detect_letterboxed", detect_step, inputs,
                          (self.model_cfg.input_shape, self.predict_cfg))

    @torch.inference_mode()
    def detect_raw_batch(self, raw_images, image_shapes) -> Dict[str, torch.Tensor]:
        """Uniform-size uint8 batch (B, H, W, 3); letterboxing runs on the
        device (the uint8 batch is what crosses to it)."""
        inputs = (self._tensor(raw_images), self._tensor(image_shapes, torch.float32))
        return self._call("detect_raw_batch", raw_detect_step, inputs,
                          (self.model_cfg.input_shape, self.predict_cfg))

    def predict_image(self, image) -> List[Dict[str, Any]]:
        """One PIL image -> list of {box, score, class} in original pixels."""
        from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image

        image = cvt_color(image)
        iw, ih = image.size
        h, w = self.model_cfg.input_shape
        boxed = resize_image(image, (w, h), letterbox_image=self.predict_cfg.letterbox_image)
        arr = np.asarray(boxed, dtype=np.float32)[None] / 255.0
        shapes = np.asarray([[ih, iw]], dtype=np.float32)
        return self.to_host_detections(self.detect_letterboxed(arr, shapes))[0]

    @torch.inference_mode()
    def class_activation_map(self, images) -> torch.Tensor:
        """Max class-probability heatmap per image at stride-8 resolution:
        (B, H/8, W/8) from letterboxed float images (B, H, W, 3)."""
        return self._call("class_activation_map", cam_step,
                          (self._tensor(images, torch.float32),), (self.model_cfg.reg_max,))

    @staticmethod
    def to_host_detections(dets: Dict[str, torch.Tensor]) -> List[List[Dict[str, Any]]]:
        """Fixed-shape device struct -> per-image python lists."""
        boxes = dets["boxes"].cpu().numpy()
        scores = dets["scores"].cpu().numpy()
        classes = dets["classes"].cpu().numpy()
        valid = dets["valid"].cpu().numpy()
        out = []
        for b in range(boxes.shape[0]):
            out.append([
                {"box": boxes[b, i].tolist(), "score": float(scores[b, i]),
                 "class": int(classes[b, i])}
                for i in np.nonzero(valid[b])[0]
            ])
        return out

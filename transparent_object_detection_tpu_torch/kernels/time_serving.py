"""Time the serving kernels of this checkout at the phi='s' 640x640 shapes,
batch 2, on one GPU; prints one JSON line (ms per call, CUDA events, 20
calls after 3 warm-ups).

    python3 transparent_object_detection_tpu_torch/kernels/time_serving.py

The package is imported from the checkout this file lies in, so two
checkouts (say a parent commit unpacked with `git archive` into a directory
that .gitignore lists) are compared on one card by running each one's copy
of this script in turns: A, B, B, A.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from transparent_object_detection_tpu_torch.kernels import _build  # noqa: E402
from transparent_object_detection_tpu_torch.ops import attention as A  # noqa: E402
from transparent_object_detection_tpu_torch.ops import attention_int8 as A8  # noqa: E402
from transparent_object_detection_tpu_torch.ops import quant_matmul as QM  # noqa: E402

# (name, (batch, tokens, channels, heads)) of the phi='s' neck TEBs at 640x640
NECK = (("h1", (2, 1600, 2048, 8)), ("h2", (2, 6400, 1536, 6)), ("h4", (2, 1600, 1536, 6)))


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("time_serving: no CUDA device", file=sys.stderr)
        return 1
    _build.build(_build.all_sources())
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    out = {}
    for name, (b, n, c, h) in NECK:
        scale = (c // h) ** -0.5
        qkv = randn(b, n, 3 * c).bfloat16()
        kq, ks = A8.quantize_kv(qkv[..., c:2 * c], h, n)
        vq, vs = A8.quantize_kv(qkv[..., 2 * c:], h, n)
        args = (qkv, kq, ks, vq, vs, h, scale, c)
        out[f"flash_mha_packed {name}"] = timed_ms(lambda: A.flash_mha_packed(qkv, h, scale))
        out[f"flash_mha_int8 {name}"] = timed_ms(lambda: A8.flash_mha_int8(*args))
        out[f"flash_mha_int8_qout {name}"] = timed_ms(lambda: A8.flash_mha_int8_qout(*args))
        payload, scales = QM._output_plain(qkv.float(), None, 3 * c, None)
        qs = A8.q_scale_table(scales, c, h)
        hk = A8.requantize_section(payload, scales, c, c, h, n)
        hv = A8.requantize_section(payload, scales, 2 * c, c, h, n)
        out[f"flash_int8_handoff {name}"] = timed_ms(
            lambda: A8.flash_int8_handoff(payload, qs, *hk, *hv, h, scale, True))
    q, k = randn(2, 6400, 64).bfloat16(), randn(2, 6400, 64).bfloat16()
    v = randn(2, 6400, 512).bfloat16()
    kq, ks = A8.quantize_kv(k, 1, 6400)
    vq, vs = A8.quantize_kv(v, 1, 6400)
    out["flash_single dark3"] = timed_ms(lambda: A.flash_single(q, k, v, 1.0))
    out["flash_mha_int8 dark3"] = timed_ms(lambda: A8.flash_mha_int8(q, kq, ks, vq, vs, 1, 1.0))
    x = randn(12800, 1536).bfloat16()
    w = QM.prepare_weights(randn(4608, 1536) / 1536 ** 0.5, randn(4608) * 0.1)
    xq, xs = QM.quant_rows(x, True)
    out["quant_rows h2 qkv"] = timed_ms(lambda: QM.quant_rows(x, True))
    out["qmm h2 qkv"] = timed_ms(lambda: QM.qmm(xq, xs, w["wq"], w["w_scale"], w["bias"]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"checkout": str(ROOT), "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The fp32 forward for Hopper (csrc/flash_fwd_f32_sm90.cu), on the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the form rule (`attention.packed_fwd_form`, `attention_vjp.lse_fwd_form`):
    at every scale (phi 'n' to 'x') and at 640x640 and 480x576, every fp32
    serving and training site, packed, single-head or folded, takes the
    fp32 Hopper kernel ("f32_sm90"); no site is left on another form (the
    CUDA-core FFMA kernel is gone);
  * the launch plan (`attention.f32_sm90_plan`) at every site: its form
    (the warpgroup split for v wider than 256 and q/k wider than 128), its
    shared memory recomputed here within the card's 227 KB, its rows and v
    slices covering the output, every wgmma N a multiple of 8 and at most
    256, every TMA row stride a multiple of 16 bytes;
  * the kernel's arithmetic, emulated in plain PyTorch: tf32 by clearing the
    13 low mantissa bits through `view(torch.int32)`, the 3xTF32 split of
    both products, the plan's row, key and v-slice tiling, and P.V through
    the A fragments built thread by thread from the S accumulator (in the
    register order the kernel source names) against V^T in the key order
    the pre-pass writes, held against the Pallas kernels in the Pallas
    interpreter at N = 1,100 under the fp32 bar (1e-4 of |ref| + 1e-4 of
    max|ref|, PERF.md); the same emulation with the low parts dropped in S
    or in P.V, or with V's keys left in their natural order, must fail it;
  * the wrappers: off the CPU they launch or raise, and
    `reset_launch_counts` clears the new counters.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

PHIS = ("n", "s", "m", "l", "x")
INPUTS = ((640, 640), (480, 576))
KERNEL_SRC = Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_fwd_f32_sm90.cu"
# the fp32 bar of PERF.md section 2, per element
RTOL, ATOL_OF_MAX = 1e-4, 1e-4
LSE_ABS = 1e-4
# score spreads chip_smoke.py holds every fp32 site at (SCORE_STDS there)
SCORE_STDS = (1.0, 4.0)
WGMMA_N_MAX = 256
SMEM_LIMIT = 232448
# (block_q, block_k) of the Pallas kernels, which take only blocks that
# divide N: 1,100 = 5 x 220 = 11 x 100
PALLAS_BLOCKS = (220, 100)
N = 1100


def sites(phi: str, hw=(640, 640)):
    """{site: (N, q/k width, v width, heads, packed qkv input)} of the
    attention calls of one forward, as tests/test_torch_scales.py builds
    them."""
    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {"dark3": (n8, max(4 * c // 8, 1), 4 * c, 1, False)}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, ch, tb._pick_num_heads(ch, 8), True)
    return out


def _fp32_calls(phi):
    """(tag, route, q/k head width, v head width, heads a call) of every fp32
    kernel call a serving or training route makes at `phi`, both inputs:
    folded heads as one-head calls on widths the fold copy pads to 8."""
    pad8 = lambda d: -(-d // 8) * 8
    out = []
    for hw in INPUTS:
        for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
            routes = {tattn.serving_route(n, cq, heads, cv, packed=packed)[0],
                      tattn.train_route(n, cq, heads, cv)}
            for route in routes - {"naive"}:
                if route == "packed":
                    out.append((f"{hw} {name}", route, cq // heads, cv // heads, heads))
                else:
                    out.append((f"{hw} {name}", route, pad8(cq // heads), pad8(cv // heads), 1))
    return out


@pytest.mark.parametrize("phi", PHIS)
def test_form_rule_every_fp32_site(phi):
    """Every fp32 serving and training call of phi n..x, 640x640 and
    480x576, takes the fp32 Hopper kernel: packed heads by
    `packed_fwd_form`, the forward with lse (packed, single-head, folded) by
    `lse_fwd_form`, the single-head serving kernel by its dtype; none is
    left on another form, and the bf16 rule is unchanged."""
    calls = _fp32_calls(phi)
    assert {route for _, route, *_ in calls} >= {"packed", "single"}, phi
    for tag, route, dqk, dv, heads in calls:
        if route == "packed":
            assert tattn.packed_fwd_form(dqk, torch.float32, dv) == "f32_sm90", tag
            assert tattn.packed_fwd_form(dqk, torch.bfloat16, dv) == "sm90", tag
        else:
            assert tvjp.lse_fwd_form(dqk, dv, 1, torch.bfloat16) == "mma_sync", tag
        assert tvjp.lse_fwd_form(dqk, dv, heads, torch.float32) == "f32_sm90", tag
    # the FFMA kernel is gone: the bf16 source keeps no fp32 form
    src = (KERNEL_SRC.parent / "flash_attn_fwd.cu").read_text()
    assert "flash_fwd_f32_kernel" not in src and "int f32" not in src


def _smem(plan, dqk) -> int:
    """Shared memory of a plan from its parts: 1 KB alignment slack, 1 KB of
    barriers; the split form's hand-over (P's fragments, hi and lo, 8 k8
    steps x 128 threads x 16 bytes; the rescale and row sums, 128 x 8 bytes
    each); Q hi and lo, the block's rows x 64 bytes a 16-column slab each,
    when resident; a q/k stage: K hi and lo of 64 keys (+ Q hi and lo when Q
    streams); the V ring: two chunks of 32 keys x the slice (sliced) or
    v_stages chunks of 16 keys x both warpgroups' halves (split), hi and
    lo."""
    split = plan["wg_split"]
    slabs = -(-dqk // 16)
    q_slab = 2 * plan["rows"] * 64
    stage = 2 * 64 * 64 + (0 if plan["q_resident"] else q_slab)
    v_stage = (2 * 2 * 16 * plan["v_slice"] * 4 if split else 2 * 32 * plan["v_slice"] * 4)
    xchg = 8 * 2 * 128 * 16 + 2 * 128 * 8 if split else 0
    return (1024 + 1024 + xchg + (slabs * q_slab if plan["q_resident"] else 0)
            + plan["stages"] * stage + plan["v_stages"] * v_stage)


@pytest.mark.parametrize("phi", PHIS)
def test_launch_plan_fits_and_covers_every_site(phi):
    """The plan of every fp32 call: the warpgroup split (64 rows, both
    warpgroups on them, each a half of v) exactly where v is wider than 256
    and q/k wider than 128, else 128 rows (two warpgroups of 64); 64-key
    tiles, 16-column slabs covering q/k; v in slices of 64-256 columns (the
    split: 192 or 256 a warpgroup) with the last block starting inside v;
    every wgmma N (64 keys for S, the slice for P.V) a multiple of 8 and at
    most 256; 2-8 q/k stages, the most that fit, two V stages; the shared
    memory recomputed within 227 KB; the TMA row strides (packed qkv views,
    the pre-pass's q/k and V^T copies) multiples of 16 bytes."""
    for tag, route, dqk, dv, heads in _fp32_calls(phi):
        plan = tattn.f32_sm90_plan(dqk, dv)
        split = plan["wg_split"]
        assert set(plan) == set(tattn.F32_SM90_PLAN_KEYS), tag
        assert split == int(dv > 256 and dqk > 128), tag
        assert (plan["rows"], plan["keys"], plan["slab"]) == (64 if split else 128, 64, 16), tag
        v_slice, splits = plan["v_slice"], plan["dv_splits"]
        assert v_slice in ((192, 256) if split else (64, 128, 192, 256)), tag
        cover = (2 if split else 1) * v_slice  # v columns a block covers
        assert splits * cover >= dv and (splits - 1) * cover < dv, tag
        for n_mma in (plan["keys"], v_slice):
            assert n_mma % 8 == 0 and 8 <= n_mma <= WGMMA_N_MAX, tag
        assert 2 <= plan["stages"] <= 8 and plan["v_stages"] == 2, tag
        assert plan["smem_bytes"] == _smem(plan, dqk) <= SMEM_LIMIT, tag
        assert plan["stages"] == 8 or tattn.f32_sm90_smem_bytes(
            dqk, v_slice, plan["stages"] + 1, plan["q_resident"], split) > SMEM_LIMIT, tag
        n = 6400
        n_pad = -(-n // 64) * 64
        row_strides = [heads * dqk * 4, n_pad * 4]  # the pre-pass's copies
        if route == "packed":
            row_strides.append(3 * heads * dqk * 4)  # q/k/v read from the packed qkv
        assert all(st % 16 == 0 for st in row_strides), tag


def test_launch_plan_choices():
    """The plans the sites of phi n, s and m get: Q resident up to q/k 128
    where the v slice lets it fit; v in one slice up to 256; the heads of
    288, 384 and 600 in the warpgroup split (2 x 192 a block: one block,
    one S, at 288 and 384; two at 600); dark3's wide v (512, 1,024) in
    slices of 256."""
    expect = {(128, 128): (0, 128, 1, 1), (32, 256): (0, 256, 1, 1),
              (64, 512): (0, 256, 2, 1), (256, 256): (0, 256, 1, 0),
              (384, 384): (1, 192, 1, 0), (288, 288): (1, 192, 1, 0),
              (600, 600): (1, 192, 2, 0), (128, 1024): (0, 256, 4, 0)}
    for (dqk, dv), want in expect.items():
        plan = tattn.f32_sm90_plan(dqk, dv)
        got = (plan["wg_split"], plan["v_slice"], plan["dv_splits"], plan["q_resident"])
        assert got == want, (dqk, dv)
    for bad in ((0, 64), (12, 64), (64, 100)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tattn.f32_sm90_plan(*bad)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _kernel_orders():
    """The kernel's choices, read from its sources: the accumulator register
    (4i + e) each A-fragment register of k8 step i takes, and the key each
    position of a group of 8 holds in V^T (the pre-pass, tf32_split.cuh)."""
    src = KERNEL_SRC.read_text()
    regs = dict(re.findall(r"fh\[i\]\[(\d)\] = __float_as_uint\(s\[4 \* i(?: \+ (\d))?\]\);",
                           src))
    order = tuple(int(regs[str(r)] or 0) for r in range(4))
    assert sorted(order) == [0, 1, 2, 3]
    # the pre-pass the kernel shares with the fp32 backward
    assert re.search(r"\(p < 4 \? 2 \* p : 2 \* p - 7\)",
                     (KERNEL_SRC.parent / "tf32_split.cuh").read_text())
    perm = tuple(2 * p if p < 4 else 2 * p - 7 for p in range(8))
    return order, perm


def _fragment_keys(order):
    """key_of[row, pos]: the key whose p the kernel hands to column pos of
    the A operand (k8 step pos // 8, column pos % 8) for row `row` of a
    warpgroup's 64, built thread by thread: accumulator register 4i + e of
    m64nNk8 is row 16w + lane/4 + 8(e/2), key 8i + 2(lane%4) + e%2; A
    fragment register r of m64nNk8 (tf32) is row 16w + lane/4 + 8(r%2),
    column lane%4 + 4(r/2)."""
    key_of = torch.full((64, 64), -1, dtype=torch.long)
    for t in range(128):
        warp, lane = divmod(t, 32)
        g, c = lane // 4, lane % 4
        for i in range(8):
            for r, e in enumerate(order):
                acc_row, acc_key = 16 * warp + g + 8 * (e // 2), 8 * i + 2 * c + e % 2
                a_row, a_col = 16 * warp + g + 8 * (r % 2), c + 4 * (r // 2)
                assert acc_row == a_row  # a register never changes rows
                key_of[a_row, 8 * i + a_col] = acc_key
    assert bool((key_of >= 0).all())
    return key_of


def _tf32(x):
    return (x.view(torch.int32) & -8192).view(torch.float32)  # 0xffffe000


def _split(x):
    hi = _tf32(x)
    return hi, x - hi


def emulate(q, k, v, scale, plan, s_lo=True, pv_lo=True, v_permuted=True):
    """csrc/flash_fwd_f32_sm90.cu's arithmetic on one-head operands q, k (G,
    N, dqk), v (G, N, dv), fp32: rows in blocks of `rows`, keys in tiles of
    `keys` (past N masked to -inf; the pre-pass's zero keys), v in the
    plan's slices (each recomputing S; a split block's slice is both its
    warpgroups' halves); S = q_hi.k_hi + (q_hi.k_lo +
    q_lo.k_hi); the exp2-domain online softmax from -1e30; P split into hi
    and lo; O += P.V through the A fragments and V^T's key order, three
    products (or one, without `pv_lo`). -> out (G, N, dv), lse (G, N)."""
    g, n, _ = q.shape
    dv = v.shape[-1]
    rows, keys = plan["rows"], plan["keys"]
    rows_pad, n_pad = -(-n // rows) * rows, -(-n // keys) * keys
    pad = lambda t, to: torch.nn.functional.pad(t, (0, 0, 0, to - n))
    qh, ql = _split(pad(q, rows_pad))
    kh, kl = _split(pad(k, n_pad))
    vh, vl = _split(pad(v, n_pad))
    order, perm = _kernel_orders()
    key_of = _fragment_keys(order).repeat(rows_pad // 64, 1).expand(g, -1, -1)
    pos = torch.arange(keys)
    vkey = (pos // 8) * 8 + (torch.tensor(perm)[pos % 8] if v_permuted else pos % 8)
    s_scale = scale * tattn.LOG2E
    out = torch.empty(g, rows_pad, dv)
    cover = (2 if plan["wg_split"] else 1) * plan["v_slice"]
    for sl in range(plan["dv_splits"]):
        cols = slice(sl * cover, min((sl + 1) * cover, dv))
        m = torch.full((g, rows_pad, 1), -1e30)
        l = torch.zeros(g, rows_pad, 1)
        o = torch.zeros(g, rows_pad, cols.stop - cols.start)
        for t in range(n_pad // keys):
            ks = slice(t * keys, (t + 1) * keys)
            s = qh @ kh[:, ks].transpose(1, 2)
            if s_lo:
                s = s + (qh @ kl[:, ks].transpose(1, 2) + ql @ kh[:, ks].transpose(1, 2))
            s = s * s_scale
            s[..., torch.arange(t * keys, (t + 1) * keys) >= n] = -torch.inf
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            ph, pl = _split(p)
            a_hi, a_lo = ph.gather(-1, key_of), pl.gather(-1, key_of)
            b_hi, b_lo = vh[:, ks][:, vkey, cols], vl[:, ks][:, vkey, cols]
            pv = a_hi @ b_hi
            if pv_lo:
                pv = pv + a_hi @ b_lo + a_lo @ b_hi
            o = o * corr + pv
        out[..., cols] = o / l
    lse = (m + torch.log2(l)) * tattn.LN2
    return out[:, :n], lse[:, :n, 0]


EMULATED_FAULTS = {"s_lo_dropped": {"s_lo": False}, "pv_lo_dropped": {"pv_lo": False},
                   "v_key_order_undone": {"v_permuted": False}}


def _bar_used(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (RTOL * np.abs(ref) + ATOL_OF_MAX * np.abs(ref).max())).max())


def _inputs(seed, heads, dqk, dv, score_std, scale):
    """q, k with scores of std `score_std` after `scale`, v standard, (1, N,
    heads * d) fp32 numpy."""
    rng = np.random.default_rng(seed)
    std = (score_std / (scale * dqk ** 0.5)) ** 0.5
    q, k = (rng.standard_normal((1, N, heads * dqk)).astype(np.float32) * std for _ in range(2))
    return q, k, rng.standard_normal((1, N, heads * dv)).astype(np.float32)


def _heads(t, heads):
    return tattn._heads_first(torch.from_numpy(t), heads).reshape(heads, N, -1)


def _hold(q, k, v, heads, scale, ref_out, ref_lse=None):
    """The emulation against the Pallas reference: -> (bar used, lse error,
    {fault: bar used (out, or lse over LSE_ABS, the larger)})."""
    plan = tattn.f32_sm90_plan(q.shape[-1] // heads, v.shape[-1] // heads)
    args = (_heads(q, heads), _heads(k, heads), _heads(v, heads), scale, plan)
    ref_out = np.asarray(ref_out, np.float32).reshape(1, N, heads, -1).transpose(0, 2, 1, 3)[0]

    def reading(out, lse):
        used = _bar_used(out.numpy(), ref_out)
        if ref_lse is None:
            return used, 0.0
        err = float(np.abs(lse.numpy() - np.asarray(ref_lse).reshape(heads, N)).max())
        return used, err

    used, lse_err = reading(*emulate(*args))
    faults = {}
    for name, kw in EMULATED_FAULTS.items():
        f_used, f_lse = reading(*emulate(*args, **kw))
        faults[name] = max(f_used, f_lse / LSE_ABS)
    return used, lse_err, faults


def _rejected_at_every_spread(readings):
    for fault in EMULATED_FAULTS:
        assert min(r[2][fault] for r in readings) > 1.0, (fault, readings)


@pytest.mark.parametrize("dh", [192, 384])
def test_emulation_matches_pallas_packed(monkeypatch, dh):
    """Packed heads (2 of 192: one streamed v slice; 2 of 384: two slices of
    192) against flash_attention_mha_packed in the Pallas interpreter, fp32,
    N = 1,100, score std 1 and 4: within the fp32 bar; each emulated fault
    rejected at both spreads."""
    monkeypatch.setattr(jattn, "INTERPRET", True)
    heads, scale = 2, dh ** -0.5
    readings = []
    for i, score_std in enumerate(SCORE_STDS):
        q, k, v = _inputs(i, heads, dh, dh, score_std, scale)
        qkv = np.concatenate([q, k, v], axis=-1)
        ref = jattn.flash_attention_mha_packed(jnp.asarray(qkv), heads, scale, *PALLAS_BLOCKS)
        readings.append(_hold(q, k, v, heads, scale, ref))
        assert readings[-1][0] <= 1.0, (score_std, readings[-1])
    _rejected_at_every_spread(readings)


def _lse_reference(q, k, v, scale, heads):
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        return jvjp.flash_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                  *PALLAS_BLOCKS, heads)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()


@pytest.mark.parametrize("dqk,dv", [(64, 512), (288, 288)])
def test_emulation_matches_pallas_single_head(dqk, dv):
    """One head (dark3 of phi='s', q/k 64 and v 512 in two slices of 256 with
    Q resident; the folded 288 of phi='n', Q streamed) against the
    single-head form of _fwd_lse_kernel in the Pallas interpreter (the
    function of _flash_kernel, whose flash_attention_pallas has no
    interpret switch), fp32, N = 1,100: out within the fp32 bar and lse
    within 1e-4; each emulated fault rejected at both spreads."""
    readings = []
    for i, score_std in enumerate(SCORE_STDS):
        q, k, v = _inputs(10 + i, 1, dqk, dv, score_std, 1.0)
        ref_out, ref_lse = _lse_reference(q, k, v, 1.0, 1)
        readings.append(_hold(q, k, v, 1, 1.0, ref_out, ref_lse))
        assert readings[-1][0] <= 1.0 and readings[-1][1] <= LSE_ABS, (score_std, readings[-1])
    _rejected_at_every_spread(readings)


def test_emulation_matches_pallas_lse_packed():
    """The training form on packed heads (2 of 128, Q resident) against
    flash_fwd_lse in the Pallas interpreter: out within the fp32 bar, lse
    within 1e-4; each emulated fault rejected at both spreads."""
    heads, dh = 2, 128
    scale = dh ** -0.5
    readings = []
    for i, score_std in enumerate(SCORE_STDS):
        q, k, v = _inputs(20 + i, heads, dh, dh, score_std, scale)
        ref_out, ref_lse = _lse_reference(q, k, v, scale, heads)
        readings.append(_hold(q, k, v, heads, scale, ref_out, ref_lse))
        assert readings[-1][0] <= 1.0 and readings[-1][1] <= LSE_ABS, (score_std, readings[-1])
    _rejected_at_every_spread(readings)


def test_wrappers_never_fall_back_off_cpu():
    """fp32 operands that are neither on the CPU nor on a card: each entry
    point raises before any library is built and counts nothing;
    reset_launch_counts clears the new counters."""
    tattn.flash_mha_packed.f32_launches = tattn.flash_single.f32_launches = 4
    tvjp.flash_fwd_lse.f32_launches = 4
    tattn.reset_launch_counts()
    tvjp.reset_launch_counts()
    counters = lambda: (tattn.flash_mha_packed.f32_launches, tattn.flash_single.f32_launches,
                        tvjp.flash_fwd_lse.f32_launches)
    assert counters() == (0, 0, 0)
    qkv = torch.empty((1, 2048, 3 * 256), dtype=torch.float32, device="meta")
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_mha_packed(qkv, 2, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_single(q.contiguous(), k.contiguous(), v.contiguous(), 1.0)
    for heads in (2, 1):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tvjp.flash_fwd_lse(q, k, v, 0.1, heads)
    assert counters() == (0, 0, 0)
    # the CPU path is the plain version, uncounted
    x = torch.randn(1, 64, 3 * 16)
    assert torch.equal(tattn.flash_mha_packed(x, 2, 0.25), tattn.flash_mha_packed_plain(x, 2, 0.25))
    assert counters() == (0, 0, 0)

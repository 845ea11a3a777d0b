"""The port's CUDA kernels against their plain PyTorch versions, on the card,
the searches (beam and CTC) on CUDA tensors against their CPU runs, the
greedy kernel against its plain version (bit for bit on dyadic inputs, the
tie-aware replay on random bf16 ones) and the recognizers' begin_decode and
begin_step without a host sync, the
zipformer v1 and LSTM pin dirs on the card, the LSTM's cuDNN recurrence
against its CPU run, and int8 (``torch._int_mm`` through its padding, the
recognizers under ``accuracy="int8"``), the native wav route and a
converted model dir on the card.

The greedy kernel is also held bit for bit in each of its regimes (weights
resident in the cluster's shared memory or streamed, ragged widths, context
1, 8 and 10, J = D = 1536, more lanes than clusters run at once).  The beam
search kernel is held against its plain version (float32: every state field
and each frame's recorded choice; bf16: the beam replay), and K1 and K2 at
heads of 128 (their chunked bodies) against their plain versions.  The
recognizers' CUDA graphs are held against their eager functions bit for
bit: offline each batch's ``_decode``, online each streaming step over the
whole lane pool (every family and search method, idle lanes untouched).

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

bias_swoosh (the zipformer2 encoder's bias + Swoosh) is held against its
plain version at the benchmark cells' shapes and layouts, ragged and
unaligned, and counted 84 times in each replay of a flagship offline graph
and streaming step: bf16 output to one bf16 ulp, float32 output to two
float32 ulps (the same float32 steps on both sides, expf and log1pf CUDA's
on both: they agree exactly unless a compiler orders a step otherwise).

The encoders' convolutions over bf16-rounded operands (``ops/layers.py``:
on the tensor cores through ``conv_tf32`` where they have 32 outputs or
more) are held against the same products in true float32 at the benchmark
cells' shapes, within (K + 2) x 2^-23 x the conv of |x| and |w| (the
float32 summation-order bound: every product of two bf16 values is exact);
each is bit for bit ``F.conv1d``/``F.conv2d`` under the TF32 flag it asks
for (set in the test); float32 convolutions on another thread, inside
``exact_f32``, stay bit for bit float32 while scoped ones run; a replay
counts 26 scoped convolutions a conformer batch, 2 a zipformer2 batch or
step and 0 on the float32 route, and leaves cuDNN's TF32 flag as the
process set it.

Tolerance, K1: float32 probs to atol 1e-5 (summation order); bf16 probs to
one bf16 ulp of the plain value (both round one float32 value).  K2: float32
ctx to atol 1e-5 (summation order: the kernel's online softmax adds the
keys in tiles); bf16 ctx to 2**-8 * max|v| + one bf16 ulp of the plain value
(the tensor-core body rounds the unnormalised probabilities to bf16 before
P.V, the plain version the normalised ones: each is within 2**-9 * max|v|
of the exact product; then both round the output once).  Searches: tokens,
timestamps, counts and contexts exactly; beam scores, sums of float32
log-probs over up to 40 frames reaching |score| ~ 130, to rtol 1e-5 plus
atol 1e-4 (summation order of the log-softmax on the card: a few float32
ulps per frame); the beam kernel's decoder outputs to atol 1e-5 and, in
bf16, its search through the beam replay at 2 ulps.  LSTM: float32
encoder output to atol 1e-5 with TF32 off (cuDNN against ATen's loop:
summation order), bf16 to atol 0.05 (bf16
linears that may round one ulp apart, over LayerNorm outputs).  int8: the
int32 product exactly; tokens and timestamps exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.decode import ctc_greedy as TCtcG
from k2transducerasr_tpu_torch.decode import rnnt_beam as TBeam
from k2transducerasr_tpu_torch.decode import rnnt_greedy as TGreedy
from k2transducerasr_tpu_torch.models import decoder as TD
from k2transducerasr_tpu_torch.models import joiner as TJ
from k2transducerasr_tpu_torch.models import lstm as TL
from k2transducerasr_tpu_torch.ops import layers as TLayers
from k2transducerasr_tpu_torch.ops import activations_cuda as ACT
from k2transducerasr_tpu_torch.ops import attention_cuda as AC
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy, tree_map
from k2transducerasr_tpu_torch.runtime.device import exact_f32
from k2transducerasr_tpu_torch.testing import beam_replay, tie_aware_replay

PIN_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def _inputs(seed, b, t, s, h, qd, pd, dtype):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    return mk(b, t, h, qd), mk(b, s, h, qd), mk(b, t, h, pd), mk(t + s - 1, h, pd)


def _assert_close(out, ref):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        return
    d = (out.float() - ref.float()).abs()
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    assert bool((d <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,t,s,h,qd,pd,lens,kw",
    [
        (2, 100, 100, 4, 32, 4, [100, 57], {}),
        (1, 130, 130, 8, 32, 4, [93], {}),
        (3, 48, 48, 4, 16, 4, [48, 1, 20], {}),
        (2, 96, 96, 4, 32, 4, None, {"chunk": 16, "left": 32}),
        (3, 8, 40, 4, 32, 4, None, {"kv_start": [32, 10, 0]}),
        (2, 37, 37, 2, 4, 2, [37, 20], {"chunk": 8, "left": 16}),  # the pin's widths
        (1, 20, 20, 2, 64, 8, None, {}),  # the widest q and pos dims taken
    ],
)
def test_kernel_matches_plain(cuda, dtype, b, t, s, h, qd, pd, lens, kw):
    q, k, pq, pk = _inputs(b + t + s, b, t, s, h, qd, pd, dtype)
    lens = None if lens is None else torch.tensor(lens, device=cuda, dtype=torch.int32)
    if "kv_start" in kw:
        kw = dict(kw, kv_start=torch.tensor(kw["kv_start"], device=cuda, dtype=torch.int32))
    before = AC.relpos_attn_probs.launches
    out = AC.relpos_attn_probs(q, k, pq, pk, lens, **kw)
    torch.cuda.synchronize()
    assert AC.relpos_attn_probs.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, h, t, s)
    _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw))


def test_kernel_out_dtype(cuda):
    q, k, pq, pk = _inputs(0, 2, 16, 16, 2, 32, 4, torch.bfloat16)
    out = AC.relpos_attn_probs(q, k, pq, pk, None, out_dtype=torch.float32)
    ref = AC.relpos_attn_probs_reference(q, k, pq, pk, None, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    # float32 inputs, bf16 probs: the float32 body's output, rounded once
    f32 = [x.float() for x in (q, k, pq, pk)]
    out = AC.relpos_attn_probs(*f32, None, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _assert_close(out, AC.relpos_attn_probs_reference(*f32, None, out_dtype=torch.bfloat16))


def _assert_ctx_close(out, ref, v):
    if out.dtype == torch.float32 and v.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        return
    d = (out.float() - ref.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    # 2^-8 * max|v|: the two sides round different probabilities to bf16
    assert bool((d <= 2.0**-8 * float(v.float().abs().max()) + ulp).all()), float(d.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,t,s,h,qd,pd,vd,lens,kw",
    [
        (3, 130, 130, 4, 64, 64, 64, [130, 1, 77], {}),  # ragged, a lane with one key
        (2, 96, 96, 2, 64, 64, 64, None, {"chunk": 16, "left": 64}),
        (3, 16, 80, 4, 64, 64, 64, None, {"kv_start": [64, 10, 0]}),  # streaming shape
        (2, 70, 70, 2, 64, 64, 32, [70, 41], {}),  # vd != qd
        (2, 37, 37, 4, 16, 16, 16, [37, 20], {"chunk": 4, "left": 8}),  # the pin's widths
        (1, 9, 200, 2, 24, 8, 40, [150], {"kv_start": [60]}),  # odd widths, T != S
    ],
)
def test_ctx_kernel_matches_plain(cuda, dtype, b, t, s, h, qd, pd, vd, lens, kw):
    q, k, pq, pk = _inputs(b + t + s + vd, b, t, s, h, qd, pd, dtype)
    scale = qd ** -0.5  # the conformer's folded 1/sqrt(dh)
    q, pq = (q.float() * scale).to(dtype), (pq.float() * scale).to(dtype)
    v = torch.from_numpy(np.random.default_rng(vd).standard_normal((b, s, h, vd)).astype(
        np.float32)).to(cuda, dtype)
    lens = None if lens is None else torch.tensor(lens, device=cuda, dtype=torch.int32)
    if "kv_start" in kw:
        kw = dict(kw, kv_start=torch.tensor(kw["kv_start"], device=cuda, dtype=torch.int32))
    before = AC.relpos_attn_ctx.launches
    out = AC.relpos_attn_ctx(q, k, pq, pk, v, lens, **kw)
    torch.cuda.synchronize()
    assert AC.relpos_attn_ctx.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, t, h, vd)
    _assert_ctx_close(out, AC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, **kw), v)


def test_ctx_kernel_out_dtype_and_fully_masked_lane(cuda):
    q, k, pq, pk = _inputs(1, 2, 20, 70, 2, 64, 64, torch.bfloat16)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 70, 2, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor([70, 5], device=cuda, dtype=torch.int32)
    kv = torch.tensor([0, 30], device=cuda, dtype=torch.int32)  # lane 1: no valid key
    out = AC.relpos_attn_ctx(q, k, pq, pk, v, lens, out_dtype=torch.float32, kv_start=kv)
    ref = AC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, out_dtype=torch.float32,
                                       kv_start=kv)
    assert out.dtype == torch.float32
    _assert_ctx_close(out, ref, v)
    torch.testing.assert_close(out[1], v[1].float().mean(dim=0).expand(20, 2, 64), atol=1e-5,
                               rtol=0)


def test_ctx_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """Wrong layouts and dtypes raise; a value head of 72 (past the old cap
    of 64) runs and equals the plain version; past MAX_HEAD (512) raises."""
    q, k, pq, pk = _inputs(0, 1, 8, 8, 2, 32, 32, torch.float32)
    v = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        AC.relpos_attn_ctx(q, k, pq, pk, v.transpose(1, 2).contiguous().transpose(1, 2), None)
    with pytest.raises(ValueError, match="dtype"):
        AC.relpos_attn_ctx(q, k, pq, pk, v.to(torch.bfloat16), None)
    v72 = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 2, 72)).astype(
        np.float32)).to(cuda)
    torch.testing.assert_close(AC.relpos_attn_ctx(q, k, pq, pk, v72, None),
                               AC.relpos_attn_ctx_reference(q, k, pq, pk, v72, None),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="vd <= 512"):
        AC.relpos_attn_ctx(q, k, pq, pk, torch.zeros((1, 8, 2, 520), device=cuda), None)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """Wrong layouts and dtypes raise; a q head of 72 (past the old cap of
    64) runs and equals the plain version; past MAX_HEAD (512) raises."""
    q, k, pq, pk = _inputs(0, 1, 8, 8, 2, 32, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        AC.relpos_attn_probs(q.transpose(1, 2).contiguous().transpose(1, 2), k, pq, pk, None)
    with pytest.raises(ValueError, match="dtype"):
        AC.relpos_attn_probs(q, k.to(torch.bfloat16), pq, pk, None)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        AC.relpos_attn_probs(q.half(), k.half(), pq.half(), pk.half(), None)
    wide = _inputs(0, 1, 8, 8, 2, 72, 4, torch.float32)
    _assert_close(AC.relpos_attn_probs(*wide, None), AC.relpos_attn_probs_reference(*wide, None))
    wider = _inputs(0, 1, 8, 8, 2, 520, 4, torch.float32)
    with pytest.raises(ValueError, match="qd <= 512"):
        AC.relpos_attn_probs(*wider, None)


# Heads past 64, the kernels' chunked bodies: q, pos and value heads of 128
# (a conformer of d_model 512 with 4 heads), a partial last chunk (qd 72, pd
# 96, vd 200: four value tiles, the last 8 wide), with ragged lens, the
# chunk window and kv_start.  (b, t, s, h, qd, pd, vd, lens, kw)
WIDE_CASES = [
    pytest.param(2, 65, 130, 2, 128, 128, 128, [130, 70], {}, id="d128"),
    pytest.param(1, 63, 63, 4, 128, 4, 128, None, {"chunk": 8, "left": 16}, id="qd128-pd4-chunk"),
    pytest.param(3, 17, 80, 2, 72, 96, 200, [80, 33, 5], {"kv_start": [63, 10, 0]},
                 id="qd72-pd96-vd200-kv_start"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,s,h,qd,pd,vd,lens,kw", WIDE_CASES)
def test_k1_and_k2_at_wide_heads(cuda, dtype, b, t, s, h, qd, pd, vd, lens, kw):
    """K1 and K2 at heads past 64 against their plain versions, at the
    tolerances of the narrow heads (module docstring); q and pos_q scaled by
    sqrt(32 / width), as a model scales its queries, so that the scores are
    as large as at the narrow heads' 32 wide."""
    q, k, pq, pk = _inputs(3, b, t, s, h, qd, pd, dtype)
    q, pq = q * (32 / qd) ** 0.5, pq * (32 / max(pd, 32)) ** 0.5
    v = torch.from_numpy(np.random.default_rng(4).standard_normal((b, s, h, vd)).astype(
        np.float32)).to(cuda, dtype)
    ln = None if lens is None else torch.tensor(lens, device=cuda)
    kw = {key: torch.tensor(x, device=cuda) if isinstance(x, list) else x for key, x in kw.items()}
    _assert_close(AC.relpos_attn_probs(q, k, pq, pk, ln, **kw),
                  AC.relpos_attn_probs_reference(q, k, pq, pk, ln, **kw))
    _assert_ctx_close(AC.relpos_attn_ctx(q, k, pq, pk, v, ln, **kw),
                      AC.relpos_attn_ctx_reference(q, k, pq, pk, v, ln, **kw), v)


# The bf16 tensor-core bodies: T and S off the 16/64 grid, T != S, narrow
# and odd widths, the chunk window, kv_start and a lane whose keys are all
# masked (lens 20, kv_start 40).  (b, t, s, h, qd, pd, vd, lens, kw); K1
# ignores vd.
TC_CASES = [
    pytest.param(2, 1, 1, 2, 32, 4, 64, None, {}, id="T1-S1"),
    pytest.param(2, 17, 40, 2, 16, 16, 16, [40, 3], {}, id="T17-S40-d16"),
    pytest.param(1, 63, 63, 4, 24, 2, 24, None, {"chunk": 8, "left": 16}, id="T63-chunk-qd24-pd2"),
    pytest.param(2, 65, 130, 2, 64, 64, 64, [130, 70], {}, id="T65-S130-d64"),
    pytest.param(1, 130, 130, 2, 4, 24, 32, [100], {"chunk": 32, "left": 64},
                 id="T130-chunk-qd4-pd24"),
    pytest.param(3, 17, 80, 2, 32, 32, 64, None, {"kv_start": [63, 10, 0]}, id="T17-S80-kv_start"),
    pytest.param(2, 65, 65, 2, 64, 4, 40, [65, 20], {"kv_start": [0, 40]}, id="all-masked-lane"),
]


def _tc_args(cuda, b, s, lens, kw):
    lens = None if lens is None else torch.tensor(lens, device=cuda, dtype=torch.int32)
    if "kv_start" in kw:
        kw = dict(kw, kv_start=torch.tensor(kw["kv_start"], device=cuda, dtype=torch.int32))
    return lens, kw


@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("b,t,s,h,qd,pd,vd,lens,kw", TC_CASES)
def test_tc_probs_matches_plain(cuda, out_dtype, b, t, s, h, qd, pd, vd, lens, kw):
    q, k, pq, pk = _inputs(7 * b + t + s, b, t, s, h, qd, pd, torch.bfloat16)
    lens, kw = _tc_args(cuda, b, s, lens, kw)
    before = AC.relpos_attn_probs.launches
    out = AC.relpos_attn_probs(q, k, pq, pk, lens, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert AC.relpos_attn_probs.launches == before + 1
    assert out.dtype == (out_dtype or torch.bfloat16) and out.shape == (b, h, t, s)
    _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, lens, out_dtype=out_dtype,
                                                      **kw))


@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("b,t,s,h,qd,pd,vd,lens,kw", TC_CASES)
def test_tc_ctx_matches_plain(cuda, out_dtype, b, t, s, h, qd, pd, vd, lens, kw):
    q, k, pq, pk = _inputs(5 * b + t + s + vd, b, t, s, h, qd, pd, torch.bfloat16)
    scale = qd ** -0.5  # the conformer's folded 1/sqrt(dh)
    q, pq = (q.float() * scale).to(torch.bfloat16), (pq.float() * scale).to(torch.bfloat16)
    v = torch.from_numpy(np.random.default_rng(vd + t).standard_normal((b, s, h, vd)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    lens, kw = _tc_args(cuda, b, s, lens, kw)
    before = AC.relpos_attn_ctx.launches
    out = AC.relpos_attn_ctx(q, k, pq, pk, v, lens, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert AC.relpos_attn_ctx.launches == before + 1
    assert out.dtype == (out_dtype or torch.bfloat16) and out.shape == (b, t, h, vd)
    _assert_ctx_close(out, AC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens,
                                                        out_dtype=out_dtype, **kw), v)


def test_tc_probs_all_masked_lane_is_uniform(cuda):
    q, k, pq, pk = _inputs(3, 2, 17, 70, 2, 32, 4, torch.bfloat16)
    lens = torch.tensor([70, 5], device=cuda, dtype=torch.int32)
    kv = torch.tensor([0, 30], device=cuda, dtype=torch.int32)  # lane 1: no valid key
    out = AC.relpos_attn_probs(q, k, pq, pk, lens, out_dtype=torch.float32, kv_start=kv)
    torch.testing.assert_close(out[1], torch.full_like(out[1], 1.0 / 70), atol=1e-7, rtol=0)


# The streaming shapes: K1 per zipformer2 stack of Zipformer2Config(causal=True)
# (chunk 32 and left 128 over downsampling 1,2,4,8,4,2; qd 32, pd 4) and of
# the zipformer2 pin (T=8, S=24 and T=4, S=12; qd 4, pd 2): (T, S, H, qd,
# pd); K2 at ConformerConfig(causal=True) (chunk 16, left 64: T=16, S=80,
# H=8, d=64) and the conformer pin (T=4, S=12, H=4, d=16): (T, S, H, d).
# kv_start per lane at 0, mid and left (= S - T).
K1_STREAMING = [(32, 160, 4, 32, 4), (16, 80, 4, 32, 4), (8, 40, 4, 32, 4), (4, 20, 8, 32, 4),
                (8, 24, 2, 4, 2), (4, 12, 2, 4, 2)]
K2_STREAMING = [(16, 80, 8, 64), (4, 12, 4, 16)]


def _kv_starts(cuda, t, s):
    return torch.tensor([0, (s - t) // 2, s - t], device=cuda, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s,h,qd,pd", K1_STREAMING,
                         ids=[f"T{c[0]}-S{c[1]}-qd{c[3]}" for c in K1_STREAMING])
def test_k1_at_the_streaming_shapes(cuda, dtype, t, s, h, qd, pd):
    q, k, pq, pk = _inputs(t * s + qd, 3, t, s, h, qd, pd, dtype)
    kv = _kv_starts(cuda, t, s)
    out = AC.relpos_attn_probs(q, k, pq, pk, None, kv_start=kv)
    torch.cuda.synchronize()
    assert out.shape == (3, h, t, s)
    _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, None, kv_start=kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s,h,d", K2_STREAMING, ids=[f"T{c[0]}-S{c[1]}" for c in K2_STREAMING])
def test_k2_at_the_streaming_shapes(cuda, dtype, t, s, h, d):
    q, k, pq, pk = _inputs(t + s, 3, t, s, h, d, d, dtype)
    q, pq = (q.float() * d**-0.5).to(dtype), (pq.float() * d**-0.5).to(dtype)
    v = torch.from_numpy(np.random.default_rng(s).standard_normal((3, s, h, d)).astype(
        np.float32)).to(cuda, dtype)
    kv = _kv_starts(cuda, t, s)
    out = AC.relpos_attn_ctx(q, k, pq, pk, v, None, kv_start=kv)
    torch.cuda.synchronize()
    _assert_ctx_close(out, AC.relpos_attn_ctx_reference(q, k, pq, pk, v, None, kv_start=kv), v)


def test_tc_probs_past_the_f32_key_cap(cuda):
    """S = 12,000 keys, past the 11,249 that the float32 body once held in
    shared memory: both bodies tile the key axis and take it."""
    q, k, pq, pk = _inputs(12, 1, 32, 12000, 2, 32, 4, torch.bfloat16)
    lens = torch.tensor([11000], device=cuda, dtype=torch.int32)
    out = AC.relpos_attn_probs(q, k, pq, pk, lens)
    torch.cuda.synchronize()
    assert out.shape == (1, 2, 32, 12000)
    _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, lens))
    f32 = [x.float() for x in (q, k, pq, pk)]
    out = AC.relpos_attn_probs(*f32, lens)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (1, 2, 32, 12000)
    _assert_close(out, AC.relpos_attn_probs_reference(*f32, lens))


@pytest.mark.parametrize("pd", [16, 64])
def test_f32_probs_at_wide_pos_heads(cuda, pd):
    """The float32 body takes pd up to 64 (it once stopped at 8), over key
    tiles with a partial last tile, ragged lens and the chunk window."""
    q, k, pq, pk = _inputs(pd, 2, 300, 300, 2, 32, pd, torch.float32)
    lens = torch.tensor([300, 161], device=cuda, dtype=torch.int32)
    for kw in ({}, {"chunk": 32, "left": 64}):
        out = AC.relpos_attn_probs(q, k, pq, pk, lens, **kw)
        torch.cuda.synchronize()
        _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw))


# -- the searches on CUDA tensors: no out-of-range scatter (a device-side
# assert on the card) and ties broken as on the CPU


def _beam_models(device, vocab=40, tied=False):
    rng = np.random.default_rng(17)
    cfg = TD.DecoderConfig(vocab_size=vocab, decoder_dim=24, context_size=2)
    dp = TD.init_params(rng, cfg)
    jp = TJ.init_params(rng, TJ.JoinerConfig(16, 24, 20, vocab))
    jp["output"]["b"][0] += 2.0  # blank runs, so the closed-form skip runs too
    if tied:  # every non-blank logit equal: ties across the K-th slot
        jp["output"]["w"][:] = 0.0
        jp["output"]["b"][:] = 0.0
        jp["output"]["b"][0] = 0.5
    return params_from_numpy(dp, device), params_from_numpy(jp, device), cfg


@pytest.mark.parametrize("k,sos,max_tokens,tied", [(4, False, 64, False), (2, True, 6, False),
                                                   (4, True, 64, True)],
                         ids=["K4", "K2-sos-full-buffer", "K4-tied"])
def test_beam_frames_skip_on_the_card_equals_cpu(cuda, k, sos, max_tokens, tied):
    enc = np.random.default_rng(5).standard_normal((3, 40, 16)).astype(np.float32)
    out = {}
    for key, dev in (("cpu", "cpu"), ("cuda", cuda)):
        dp, jp, cfg = _beam_models(dev, tied=tied)
        proj = TJ.project_encoder(jp, torch.from_numpy(enc).to(dev))
        st = TBeam.init_state(dp, cfg, jp, 3, k, max_tokens)
        out[key] = TBeam.beam_frames_skip(
            dp, cfg, jp, st, proj, torch.tensor([40, 0, 23], device=dev),
            torch.tensor([0, 0, 5], device=dev), sos, window=8)
    got, want = out["cuda"], out["cpu"]
    for f in ("hyp", "tokens", "timestamps", "count"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.score.cpu(), want.score, atol=1e-4, rtol=1e-5)
    for g, w in zip(TBeam.nbest_beams(got), TBeam.nbest_beams(want)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-5)


def test_ctc_frames_on_the_card_equals_cpu(cuda):
    """Chunks of a ragged batch with a buffer that overflows: positions past
    ``max_tokens`` are dropped on the card as on the CPU."""
    rng = np.random.default_rng(6)
    chunks = [(rng.standard_normal((4, 16, 9)) * 3).astype(np.float32) for _ in range(3)]
    lens = [[16, 5, 0, 16], [16, 16, 1, 0], [3, 16, 16, 0]]
    out = {}
    for key, dev in (("cpu", "cpu"), ("cuda", cuda)):
        st = TCtcG.init_state(4, 10, device=dev)
        off = torch.zeros(4, dtype=torch.int64, device=dev)
        for lp, n in zip(chunks, lens):
            n = torch.tensor(n, device=dev)
            st = TCtcG.ctc_frames(st, torch.from_numpy(lp).to(dev), n, off)
            off = off + n
        out[key] = st
    assert int(out["cpu"].count.max()) == 10  # a lane overflowed
    for f in ("tokens", "timestamps", "count", "prev", "trailing_blanks"):
        assert torch.equal(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f)), f


def _host_syncs(fn):
    """fn() under torch.cuda's sync debug mode: the synchronising calls it
    made (each warns)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [w for w in caught if "synchroniz" in str(w.message).lower()]


def test_beam_trip_syncs_the_host_once(cuda):
    """The plain version on the card: one host sync per trip (the loop
    condition, and once more to end the loop), none inside a trip; the
    wrapper (the kernel) none at all."""
    dp, jp, cfg = _beam_models(cuda)
    enc = np.random.default_rng(5).standard_normal((3, 40, 16)).astype(np.float32)
    proj = TJ.project_encoder(jp, torch.from_numpy(enc).to(cuda))
    st = TBeam.init_state(dp, cfg, jp, 3, 4, 64)
    lens = torch.tensor([40, 0, 23], device=cuda)
    off = torch.zeros(3, dtype=torch.int64, device=cuda)
    TBeam.beam_frames_skip.trips = 0
    syncs = _host_syncs(lambda: TBeam.beam_frames_skip_reference(dp, cfg, jp, st, proj, lens, off,
                                                                 True, window=8))
    assert TBeam.beam_frames_skip.trips > 0
    assert len(syncs) == TBeam.beam_frames_skip.trips + 1
    ops = TGreedy.greedy_operands(dp, cfg, jp)
    call = lambda: TBeam.beam_frames_skip(dp, cfg, jp, st, proj, lens, off, True,  # noqa: E731
                                          window=8, operands=ops)
    call()  # the build, and the library's first load
    TBeam.beam_frames_skip.trips = 0
    assert _host_syncs(call) == [] and TBeam.beam_frames_skip.trips == 0


def test_ctc_frames_does_not_sync(cuda):
    lp = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 16, 9)).astype(
        np.float32)).to(cuda)
    st = TCtcG.init_state(4, 10, device=cuda)
    lens = torch.tensor([16, 5, 0, 16], device=cuda)
    off = torch.zeros(4, dtype=torch.int64, device=cuda)
    assert _host_syncs(lambda: TCtcG.ctc_frames(st, lp, lens, off)) == []


# -- the greedy kernel (csrc/rnnt_greedy.cu) against its plain version


def _dyadic_greedy(device, dtype, v=70, d=40, j=36, ctx=2, seed=0):
    """A decoder and joiner whose values are small multiples of powers of
    two, and encoder frames, such that every float32 sum the search takes
    is exact, in any order: the kernel then equals the plain version bit for
    bit, ties included.  Output columns 4 .. V-1 come in equal pairs (exact
    ties, where the first index must win); blank and sos get large biases, so
    blank runs and sos frames occur.  For float32 the frames are +-16 .. 28,
    where tanh is exactly +-1; for bf16 +-1 .. 1.75, where it is not and the
    decoder state moves the logits."""
    rng = np.random.default_rng(seed)
    q = lambda lo, hi, scale, shape: (rng.integers(lo, hi + 1, shape) * scale).astype(  # noqa: E731
        np.float32)
    cfg = TD.DecoderConfig(vocab_size=v, decoder_dim=d, context_size=ctx)
    dp = {"embedding": {"table": q(-2, 2, 0.25, (v, d))}}
    if ctx > 1:
        dp["conv"] = {"w": q(-1, 1, 0.25, (ctx, 4, d))}
    w_out = q(-2, 2, 0.125, (j, v))
    w_out[:, 5::2] = w_out[:, 4:v - 1:2][:, :w_out[:, 5::2].shape[1]]
    b_out = q(-2, 2, 0.125, (v,))
    b_out[5::2] = b_out[4:v - 1:2][:b_out[5::2].shape[0]]
    b_out[0] += 2.5
    b_out[1] += 2.0
    jp = {"encoder_proj": {"w": q(-1, 1, 0.25, (8, j)), "b": np.zeros(j, np.float32)},
          "decoder_proj": {"w": q(-1, 1, 2.0**-7, (d, j)), "b": q(-1, 1, 2.0**-6, (j,))},
          "output": {"w": w_out, "b": b_out}}
    big = 16.0 if dtype is None else 1.0
    return params_from_numpy(dp, device), params_from_numpy(jp, device), cfg, big


def _dyadic_frames(rng, b, t, j, big):
    mag = big * (1.0 + rng.integers(0, 4, (b, t, j)) * 0.25)
    return (mag * rng.choice([-1.0, 1.0], (b, t, j))).astype(np.float32)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ctx,skip_sos,max_tokens", [(1, False, 64), (2, True, 64),
                                                     (2, False, 9)],
                         ids=["ctx1", "ctx2-skip-sos", "ctx2-full-buffer"])
def test_greedy_kernel_bit_for_bit_on_dyadic_inputs(cuda, dtype, ctx, skip_sos, max_tokens):
    """Kernel against plain on the card, every state field exactly: a ragged
    batch (a lane of 0 frames, one shorter than a tile), per-lane
    frame_offset, J, V and D off the kernel's 16/8 grids, then a second,
    chained call from the first's state.  The state it starts from is left
    as it was."""
    dp, jp, cfg, big = _dyadic_greedy(cuda, dtype, ctx=ctx)
    rng = np.random.default_rng(ctx + max_tokens)
    lens = torch.tensor([47, 0, 5, 30], device=cuda)
    offset = torch.tensor([0, 3, 100, 7], device=cuda)
    st = TGreedy.init_state(dp, cfg, jp, 4, max_tokens, dtype)
    ops = TGreedy.greedy_operands(dp, cfg, jp, dtype)
    for call in range(2):
        enc = torch.from_numpy(_dyadic_frames(rng, 4, 47, 36, big)).to(cuda)
        enc = enc if dtype is None else enc.to(dtype)
        before = TGreedy.greedy_frames_skip.launches
        fields = [f.name for f in dataclasses.fields(st)]
        kept = [getattr(st, f).clone() for f in fields]
        got = TGreedy.greedy_frames_skip(dp, cfg, jp, st, enc, lens, offset, skip_sos, dtype,
                                         operands=ops)
        torch.cuda.synchronize()
        assert TGreedy.greedy_frames_skip.launches == before + 1
        assert all(torch.equal(x, getattr(st, f)) for x, f in zip(kept, fields))
        want = TGreedy.greedy_frames_skip_reference(dp, cfg, jp, st, enc, lens, offset,
                                                    skip_sos, dtype)
        for f in ("hyp", "dec_proj", "tokens", "timestamps", "count", "trailing_blanks"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (call, f)
        st, offset = got, offset + lens
    assert int(got.count.max()) > 4 and int(got.count[1]) == 0
    if max_tokens == 9:
        assert int(got.count.max()) == 9


# Each regime of the cluster kernel (csrc/rnnt_greedy.cu), in both dtypes:
# (J, D, V, context, lanes, frames, where the weights live).  "resident":
# every block's share of W_out and decoder_proj in its shared memory (bf16 at
# the flagship's 512/512/500); "streamed": some of it through the rings every
# step (J = D = 1024 and 1536, past the old cap of 1024, the float32 one
# through rings of one stage; V = 5,500; float32 at the flagship); "ragged": V
# not a multiple of 64 nor of 8, J and D not multiples of 16 (bf16 frames of
# 200 bytes); context 1, 8 and 10 (past the old cap of 8); 32 lanes, more
# clusters than run at once.  Every case has a lane of 0 frames and one whose buffer is full on
# entry.
GREEDY_REGIMES = [
    ("flagship", 512, 512, 500, 2, 6, 40),
    ("wide-1024", 1024, 1024, 500, 2, 6, 40),
    ("vocab-5500", 512, 512, 5500, 2, 6, 40),
    ("ragged", 100, 92, 203, 2, 6, 40),
    ("ctx1", 512, 512, 500, 1, 6, 40),
    ("ctx8", 512, 512, 500, 8, 6, 40),
    ("wide-1536-ctx10", 1536, 1536, 500, 10, 6, 40),
    ("lanes-32", 512, 512, 500, 2, 32, 24),
]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("j,d,v,ctx,b,t", [c[1:] for c in GREEDY_REGIMES],
                         ids=[c[0] for c in GREEDY_REGIMES])
def test_greedy_kernel_regimes_bit_for_bit(cuda, dtype, j, d, v, ctx, b, t):
    """Kernel against plain on dyadic inputs, every state field exactly, with
    the regime the case stands for checked on the kernel's plan."""
    dp, jp, cfg, big = _dyadic_greedy(cuda, dtype, v=v, d=d, j=j, ctx=ctx, seed=ctx + b)
    rng = np.random.default_rng(j + v)
    max_tokens = 48
    lens = torch.from_numpy(rng.integers(1, t + 1, b)).to(cuda)
    lens[0], lens[1], lens[2] = t, 0, t  # a full lane, an empty lane, a lane full on entry
    offset = torch.from_numpy(rng.integers(0, 1000, b)).to(cuda)
    st = TGreedy.init_state(dp, cfg, jp, b, max_tokens, dtype)
    st.count[2] = max_tokens
    enc = torch.from_numpy(_dyadic_frames(rng, b, t, j, big)).to(cuda)
    enc = enc if dtype is None else enc.to(dtype)
    ops = TGreedy.greedy_operands(dp, cfg, jp, dtype)
    got = TGreedy.greedy_frames_skip(dp, cfg, jp, st, enc, lens, offset, False, dtype,
                                     operands=ops)
    torch.cuda.synchronize()
    # the plain version's bf16 products summed in float32, as the kernel's
    # (cuBLAS may otherwise reduce split sums in bf16)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = TGreedy.greedy_frames_skip_reference(dp, cfg, jp, st, enc, lens, offset, False,
                                                    dtype)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    for f in ("hyp", "dec_proj", "tokens", "timestamps", "count", "trailing_blanks"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.count[0]) > 4 and int(got.count[1]) == 0
    assert int(got.count[2]) == max_tokens and int(got.trailing_blanks[2]) == t
    plan = TGreedy.kernel_plan(j, d, v, dtype, ctx)
    resident = (plan["resident_ntiles"] == plan["ntiles_per_rank"]
                and plan["resident_chunks"] == plan["chunks_per_rank"])
    streamed = (j >= 1024 or v == 5500 or (dtype is None and j == 512))
    assert resident != streamed, plan
    assert plan["ring_stages"] == (1 if dtype is None and j == 1536 else 2), plan
    if b > plan["max_active_clusters"]:
        assert b == 32  # the lanes ran in waves


def test_greedy_kernel_emits_sos_only_offline_and_breaks_ties_low(cuda):
    """On the dyadic inputs: offline, sos (1) is emitted; online it never is;
    and no token from an equal pair's higher index (5, 7, ...) appears."""
    dp, jp, cfg, big = _dyadic_greedy(cuda, None)
    enc = torch.from_numpy(_dyadic_frames(np.random.default_rng(1), 4, 60, 36, big)).to(cuda)
    lens, zero = torch.full((4,), 60, device=cuda), torch.zeros(4, dtype=torch.long, device=cuda)
    out = {}
    for sos in (False, True):
        st = TGreedy.init_state(dp, cfg, jp, 4, 128)
        out[sos] = TGreedy.greedy_frames_skip(dp, cfg, jp, st, enc, lens, zero, sos)
    toks = {sos: [t for i, n in enumerate(o.count.tolist()) for t in o.tokens[i, :n].tolist()]
            for sos, o in out.items()}
    assert 1 in toks[False] and 1 not in toks[True]
    assert not any(t >= 5 and t % 2 == 1 for t in toks[False] + toks[True])
    assert any(t >= 4 and t % 2 == 0 for t in toks[False])


def test_greedy_kernel_random_bf16_passes_the_replay(cuda):
    """Random weights at bf16, where summation order may flip near-ties:
    the kernel's run passes the tie-aware replay at 2 ulps."""
    rng = np.random.default_rng(3)
    cfg = TD.DecoderConfig(vocab_size=500, decoder_dim=64, context_size=2)
    dp = params_from_numpy(TD.init_params(rng, cfg), cuda)
    jp = params_from_numpy(TJ.init_params(rng, TJ.JoinerConfig(48, 64, 96, 500)), cuda)
    enc = torch.from_numpy(rng.standard_normal((5, 90, 96)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    lens, off = torch.tensor([90, 64, 1, 0, 17], device=cuda), torch.arange(5, device=cuda)
    st = TGreedy.init_state(dp, cfg, jp, 5, 256, torch.bfloat16)
    got = TGreedy.greedy_frames_skip(dp, cfg, jp, st, enc, lens, off, True, torch.bfloat16)
    res = tie_aware_replay(dp, cfg, jp, st, enc, lens, off, got, True, torch.bfloat16)
    assert res.ok, res.reason
    assert res.frames == 90 + 64 + 1 + 17


def test_greedy_frames_skip_does_not_sync(cuda):
    dp, jp, cfg, big = _dyadic_greedy(cuda, torch.bfloat16)
    enc = torch.from_numpy(_dyadic_frames(np.random.default_rng(2), 3, 20, 36, big)).to(
        cuda, torch.bfloat16)
    lens, off = torch.tensor([20, 3, 0], device=cuda), torch.zeros(3, dtype=torch.long,
                                                                     device=cuda)
    st = TGreedy.init_state(dp, cfg, jp, 3, 32, torch.bfloat16)
    ops = TGreedy.greedy_operands(dp, cfg, jp, torch.bfloat16)
    call = lambda: TGreedy.greedy_frames_skip(dp, cfg, jp, st, enc, lens, off, False,  # noqa: E731
                                              torch.bfloat16, operands=ops)
    call()  # the build, and the library's first load
    assert _host_syncs(call) == []
    assert _host_syncs(lambda: TGreedy.greedy_operands(dp, cfg, jp, torch.bfloat16)) == []


def _replayed(rec, fn):
    """fn(), a begin_decode (or begin_step) of a shape ``rec.program`` has
    captured: it adds no graph and runs the shape's one graph (a replay: no
    wrapper counts a launch but the program)."""
    entries = dict(rec.program.entries)
    assert entries and all(e.graph is not None for e in entries.values())
    fn()
    assert list(rec.program.entries) == list(entries)
    assert all(rec.program.entries[k] is e for k, e in entries.items())


@pytest.mark.parametrize("family,compat", [("zipformer2", False), ("zipformer2", True),
                                           ("zipformer2ctc", False), ("zipformer2ctc", True)],
                         ids=["greedy", "greedy-compat", "ctc", "ctc-compat"])
def test_begin_decode_and_begin_step_do_not_sync(cuda, family, compat):
    """On the pin dirs at bf16: OfflineRecognizer.begin_decode (greedy or
    CTC, with and without reference_pad_compat) and OnlineRecognizer.
    begin_step return without a host sync; end_decode still gives the pin."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, reference_pad_compat=compat, device="cuda")
    streams = [rec.create_offline_stream() for _ in range(3)]
    for i, s in enumerate(streams):
        s.add_samples(_pcm(6400 - 1000 * i))
    rec.get_results(streams)  # warm: the build, the handles, the graph's capture
    pending = []
    assert _host_syncs(lambda: _replayed(rec, lambda: pending.append(rec.begin_decode(streams))))\
        == []
    assert [r.text for r in rec.end_decode(pending[0])] == [
        r.text for r in rec.get_results(streams)]
    if compat:
        return
    online = OnlineRecognizer(bundle, max_lanes=2, device="cuda")
    stream = online.create_online_stream()
    stream.add_samples(_pcm(32000))
    online.get_results([stream])
    assert stream._ready()  # the step below runs the encoder and the search
    pending = []
    assert _host_syncs(lambda: _replayed(online, lambda: pending.append(
        online.begin_step([stream])))) == []
    online.end_step(pending[0])


def test_greedy_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dp, jp, cfg, big = _dyadic_greedy(cuda, None)
    enc = torch.zeros((2, 5, 36), device=cuda)
    lens, off = torch.tensor([5, 5], device=cuda), torch.zeros(2, dtype=torch.long, device=cuda)
    st = TGreedy.init_state(dp, cfg, jp, 2, 8)
    run = TGreedy.greedy_frames_skip
    with pytest.raises(ValueError, match="must be"):
        run(dp, cfg, jp, st, enc.to(torch.bfloat16), lens, off)  # bf16 frames, float32 search
    with pytest.raises(ValueError, match="operands built for"):
        run(dp, cfg, jp, st, enc, lens, off,
            operands=TGreedy.greedy_operands(dp, cfg, jp, torch.bfloat16))
    with pytest.raises(ValueError, match="compute_dtype"):
        run(dp, cfg, jp, st, enc.half(), lens, off, compute_dtype=torch.float16)
    # past the old caps (J, D <= 1024, context <= 8): taken, as the plain version
    wide = TJ.init_params(np.random.default_rng(0), TJ.JoinerConfig(8, 40, 1040, 70))
    wide = params_from_numpy(wide, cuda)
    st_wide = TGreedy.init_state(dp, cfg, wide, 2, 8)
    enc_wide = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, 1040)).astype(
        np.float32)).to(cuda)
    for f in ("tokens", "count", "hyp"):
        assert torch.equal(getattr(run(dp, cfg, wide, st_wide, enc_wide, lens, off), f),
                           getattr(TGreedy.greedy_frames_skip_reference(
                               dp, cfg, wide, st_wide, enc_wide, lens, off), f)), f
    deep = TD.DecoderConfig(vocab_size=70, decoder_dim=40, context_size=9)
    deep_p = params_from_numpy(TD.init_params(np.random.default_rng(0), deep), cuda)
    st_deep = TGreedy.init_state(deep_p, deep, jp, 2, 8)
    enc_deep = enc + torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 36)).astype(np.float32)).to(cuda)
    assert torch.equal(run(deep_p, deep, jp, st_deep, enc_deep, lens, off).hyp,
                       TGreedy.greedy_frames_skip_reference(deep_p, deep, jp, st_deep, enc_deep,
                                                            lens, off).hyp)
    # what still raises: a joiner whose fixed parts leave no room in a block
    huge = TJ.init_params(np.random.default_rng(0), TJ.JoinerConfig(8, 40, 4096, 70))
    huge = params_from_numpy(huge, cuda)
    st_huge = TGreedy.init_state(dp, cfg, huge, 2, 8)
    with pytest.raises(ValueError, match="does not take these shapes"):
        run(dp, cfg, huge, st_huge, torch.zeros((2, 5, 4096), device=cuda), lens, off)
    ops = TGreedy.greedy_operands(dp, cfg, jp)
    for field in ("tables", "dec_w", "dec_b", "out_w", "out_b"):
        moved = dataclasses.replace(ops, **{field: getattr(ops, field).cpu()})
        with pytest.raises(ValueError, match="enc_proj's device"):
            run(dp, cfg, jp, st, enc, lens, off, operands=moved)


# -- the beam search kernel (csrc/rnnt_beam.cu) against its plain version

# (K, vocab, J, D, context, lanes, frames, window, extra_skip_sos, max_tokens,
# blank bias): blank runs (windows folded, the closed-form trips), a buffer
# that fills, one beam, 8 and 16 beams (16 at a vocabulary of 5: candidates
# at NEG_INF in the top K, ties by index), context 1 and 3, the flagship's
# widths (J = D = 512, V = 500) and a vocabulary of 5,500 (the weights
# streamed).  Every case has a lane of 0 frames.  Each runs with one lane a
# cluster (P = 1) and, where P K <= 16, two (P = 2: lanes paired by length,
# an odd lane alone in the last cluster); the flagship also with four (P =
# 4: all 16 rows of the tile).
_BEAM_KERNEL_SHAPES = [
    ((4, 40, 20, 24, 2, 3, 40, 64, False, 64, 0.3), "K4"),
    ((2, 40, 20, 24, 2, 3, 40, 8, True, 6, -0.5), "K2-sos-full-buffer-w8"),
    ((2, 40, 20, 24, 2, 3, 40, 8, True, 64, 1.2), "K2-sos-blank-runs-w8"),
    ((1, 40, 20, 24, 2, 2, 30, 16, False, 64, 0.6), "K1"),
    ((8, 70, 36, 40, 1, 4, 50, 16, False, 64, 1.2), "K8-ctx1"),
    ((16, 5, 24, 24, 3, 2, 30, 64, True, 64, 0.0), "K16-v5-ctx3"),
    ((4, 500, 512, 512, 2, 4, 60, 64, False, 1024, 0.0), "flagship"),
    ((4, 5500, 512, 512, 2, 2, 30, 64, False, 1024, 0.0), "vocab-5500"),
]
BEAM_KERNEL_CASES = [
    pytest.param(*shape, lanes, id=f"{name}-P{lanes}")
    for shape, name in _BEAM_KERNEL_SHAPES
    for lanes in ((1, 2, 4) if name == "flagship" else (1, 2) if shape[0] <= 8 else (1,))
]


@pytest.fixture
def force_lanes(monkeypatch):
    """``force_lanes(p)``: the beam wrapper launches p lanes a cluster for
    the rest of the test (its choice of P replaced, its cached launch shapes
    dropped on both sides)."""
    def force(lanes):
        monkeypatch.setattr(TBeam, "lanes_per_cluster", lambda batch, beams, at_once: lanes)
        TBeam._kernel_lanes.cache_clear()
    yield force
    TBeam._kernel_lanes.cache_clear()


def _beam_kernel_models(device, k, v, j, d, ctx, bias, seed=21):
    rng = np.random.default_rng(seed)
    cfg = TD.DecoderConfig(vocab_size=v, decoder_dim=d, context_size=ctx)
    dp = TD.init_params(rng, cfg)
    jp = TJ.init_params(rng, TJ.JoinerConfig(16, d, j, v))
    jp["output"]["b"][0] += bias
    return params_from_numpy(dp, device), params_from_numpy(jp, device), cfg


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,v,j,d,ctx,b,t,window,sos,max_tokens,bias,lanes", BEAM_KERNEL_CASES)
def test_beam_kernel_matches_plain(cuda, force_lanes, dtype, k, v, j, d, ctx, b, t, window, sos,
                                   max_tokens, bias, lanes):
    """Two chained calls (the streaming shape) from init_state, ragged lens
    with an empty lane, per-lane frame_offset, ``lanes`` lanes a cluster.
    float32: every state field and each frame's recorded choice equal to
    the plain version's on the card, the scores and recorded scores to atol
    1e-4 + rtol 1e-5 and the decoder outputs to atol 1e-5 (summation
    order); bf16: the beam replay at 2 ulps.  The second exchange's count
    stays within each lane's emission steps.  The state it starts from is
    left as it was."""
    dp, jp, cfg = _beam_kernel_models(cuda, k, v, j, d, ctx, bias)
    force_lanes(lanes)
    rng = np.random.default_rng(k + v + t)
    lens = torch.from_numpy(rng.integers(1, t + 1, b)).to(cuda)
    lens[0], lens[1] = t, 0
    offset = torch.from_numpy(rng.integers(0, 500, b)).to(cuda)
    st = TBeam.init_state(dp, cfg, jp, b, k, max_tokens, dtype)
    ops = TGreedy.greedy_operands(dp, cfg, jp, dtype)
    valid = torch.arange(t, device=cuda)[None, :] < lens[:, None]
    for call in range(2):
        enc = torch.from_numpy(rng.standard_normal((b, t, 16)).astype(np.float32)).to(cuda)
        proj = TJ.project_encoder(jp, enc, dtype)
        kept = [x.clone() for x in dataclasses.astuple(st)]
        before = TBeam.beam_frames_skip.launches
        trace = TBeam.BeamTrace.empty(b, t, k, cuda)
        got = TBeam.beam_frames_skip(dp, cfg, jp, st, proj, lens, offset, sos, dtype, window,
                                     operands=ops, trace=trace)
        torch.cuda.synchronize()
        assert TBeam.beam_frames_skip.launches == before + 1
        kind = trace.fields()[2]
        emission_steps = ((kind == TBeam.STEP_EMIT)[..., 0] & valid).sum(1)
        assert bool((trace.second >= 0).all() and (trace.second <= emission_steps).all())
        assert all(torch.equal(x, y) for x, y in zip(kept, dataclasses.astuple(st)))
        if dtype is None:
            plain = TBeam.BeamTrace.empty(b, t, k, cuda)
            with exact_f32():
                want = TBeam.beam_frames_skip_reference(dp, cfg, jp, st, proj, lens, offset, sos,
                                                        dtype, window, plain)
            for f in ("hyp", "tokens", "timestamps", "count"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (call, f)
            torch.testing.assert_close(got.score, want.score, atol=1e-4, rtol=1e-5)
            torch.testing.assert_close(got.dec_proj, want.dec_proj, atol=1e-5, rtol=0)
            assert torch.equal(trace.steps[valid], plain.steps[valid]), call
            torch.testing.assert_close(trace.values[valid], plain.values[valid], atol=1e-4,
                                       rtol=1e-5)
        else:
            res = beam_replay(dp, cfg, jp, st, proj, lens, offset, got, trace, sos, dtype,
                              window=window)
            assert res.ok, (call, res.reason)
        st, offset = got, offset + lens
    assert int(got.count[0].max()) > 0 and int(got.count[1].max()) == 0
    if max_tokens == 6:
        assert int(got.count.max()) == 6


def test_beam_kernel_plan_matches_the_host_mirror(cuda):
    """k2t_rnnt_beam_plan (the card's shared-memory limit) against
    rnnt_beam.plan_bytes, the host's mirror, over the regimes above."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for args in [(512, 512, 500, 2, 4), (512, 512, 500, 2, 8), (512, 512, 5500, 2, 4),
                 (20, 24, 40, 2, 16), (1024, 1024, 500, 2, 4), (36, 40, 70, 1, 8)]:
        for dtype, lanes in [(None, 1), (torch.bfloat16, 1), (None, 2), (torch.bfloat16, 2)]:
            if lanes * args[4] > 16:
                continue
            got = TBeam.kernel_plan(*args, dtype, lanes)
            want = TBeam.plan_bytes(*args, dtype, limit=limit, lanes=lanes)
            assert got["smem_bytes"] == want["smem_bytes"], (args, dtype, lanes, got, want)
            assert (got["resident_ntiles"], got["resident_chunks"], got["stage_ntiles"],
                    got["stage_chunks"], got["ring_stages"]) == (
                want["res_w"], want["res_d"], want["sw"], want["sd"], want["depth"]), (args, dtype)


def test_beam_wrapper_rejects_what_the_kernel_does_not_take(cuda, force_lanes):
    dp, jp, cfg = _beam_kernel_models(cuda, 4, 40, 20, 24, 2, 2.0)
    st = TBeam.init_state(dp, cfg, jp, 2, 4, 8)
    enc = torch.zeros((2, 5, 20), device=cuda)
    lens, off = torch.tensor([5, 5], device=cuda), torch.zeros(2, dtype=torch.long, device=cuda)
    run = TBeam.beam_frames_skip
    with pytest.raises(ValueError, match="must be"):
        run(dp, cfg, jp, st, enc.to(torch.bfloat16), lens, off)
    with pytest.raises(ValueError, match="operands built for"):
        run(dp, cfg, jp, st, enc, lens, off,
            operands=TGreedy.greedy_operands(dp, cfg, jp, torch.bfloat16))
    with pytest.raises(ValueError, match="1..16 beams"):
        run(dp, cfg, jp, TBeam.init_state(dp, cfg, jp, 2, 17, 8), enc, lens, off)
    with pytest.raises(ValueError, match="trace"):
        run(dp, cfg, jp, st, enc, lens, off, trace=TBeam.BeamTrace.empty(2, 4, 4, cuda))
    ops = TGreedy.greedy_operands(dp, cfg, jp)
    for field in ("tables", "out_w"):
        moved = dataclasses.replace(ops, **{field: getattr(ops, field).cpu()})
        with pytest.raises(ValueError, match="enc_proj's device"):
            run(dp, cfg, jp, st, enc, lens, off, operands=moved)
    force_lanes(5)  # 5 lanes of 4 beams: more rows than the tile's 16
    with pytest.raises(ValueError, match="lanes_per_cluster"):
        run(dp, cfg, jp, st, enc, lens, off)


@pytest.mark.parametrize("hotwords", [False, True], ids=["beam", "beam-hotwords"])
def test_begin_decode_and_begin_step_do_not_sync_under_beam_search(cuda, hotwords):
    """On the zipformer2 pin dir at bf16 under modified_beam_search (K=4),
    with and without hotwords: begin_decode and begin_step return without a
    host sync; end_decode gives what get_results gives."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    kw = dict(decoding_method="modified_beam_search", max_active_paths=4, device="cuda",
              hotwords=["tok6tok25"] if hotwords else None)
    rec = OfflineRecognizer(bundle, **kw)
    streams = [rec.create_offline_stream() for _ in range(3)]
    for i, s in enumerate(streams):
        s.add_samples(_pcm(6400 - 1000 * i))
    want = [r.text for r in rec.get_results(streams)]  # warm: the build, the handles, capture
    pending = []
    assert _host_syncs(lambda: _replayed(rec, lambda: pending.append(rec.begin_decode(streams))))\
        == []
    assert [r.text for r in rec.end_decode(pending[0])] == want
    online = OnlineRecognizer(bundle, max_lanes=2, **kw)
    stream = online.create_online_stream()
    stream.add_samples(_pcm(32000))
    online.get_results([stream])
    assert stream._ready()
    pending = []
    assert _host_syncs(lambda: _replayed(online, lambda: pending.append(
        online.begin_step([stream])))) == []
    online.end_step(pending[0])


# K1 at zipformer v1's shapes (ZipformerConfig(): 8 heads, q head 24 = 192/8,
# which the bf16 body pads to 32, pos_dim 4): the offline stacks of a
# 16 x 30 s batch (T = S = 1532, 766, 383, 192) with ragged lens, and the
# streaming stacks of ZipformerConfig(causal=True) (chunk 16, left 64:
# T = 16 ... 2 queries against S = T + left keys) with kv_start per lane.
K1_V1 = [(1532, 1532), (766, 766), (383, 383), (192, 192), (16, 80), (8, 40), (4, 20),
         (2, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s", K1_V1, ids=[f"T{t}-S{s}" for t, s in K1_V1])
def test_k1_at_zipformer_v1_shapes(cuda, dtype, t, s):
    q, k, pq, pk = _inputs(t + s, 3, t, s, 8, 24, 4, dtype)
    if t == s:
        lens, kv = torch.tensor([s, s // 2 + 1, 1], device=cuda, dtype=torch.int32), None
    else:
        lens, kv = None, _kv_starts(cuda, t, s)
    before = AC.relpos_attn_probs.launches
    out = AC.relpos_attn_probs(q, k, pq, pk, lens, kv_start=kv)
    torch.cuda.synchronize()
    assert AC.relpos_attn_probs.launches == before + 1 and out.shape == (3, 8, t, s)
    _assert_close(out, AC.relpos_attn_probs_reference(q, k, pq, pk, lens, kv_start=kv))


def _pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's signal."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


# tests/test_pinned_transcripts.py's pins: (offline text, timestamps, online
# text) and the K1 launches of one offline decode (one per layer)
V1_LSTM_PINS = {
    "zipformer": ("tok5tok17tok5tok17tok5tok17tok5tok17", list(range(8)),
                  "tok5tok17tok5tok17tok5tok17tok5tok17tok5tok23", 2),
    "lstm": ("tok6tok15tok15tok15tok15tok15tok15", list(range(8)),
             "tok6tok15tok15tok15tok15tok15tok15tok9tok9tok9tok9tok9tok9", 0),
}


@pytest.mark.parametrize("family", list(V1_LSTM_PINS))
def test_zipformer_v1_and_lstm_pins_on_the_card(cuda, family):
    text, stamps, online_text, k1 = V1_LSTM_PINS[family]
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
    s = rec.create_offline_stream()
    s.add_samples(_pcm(6400))
    rec.get_result(s)  # captures the batch shape's graph (a warm-up run, then a replay)
    before = (AC.relpos_attn_probs.launches, AC.relpos_attn_ctx.launches)
    res = rec.get_result(s)
    assert (AC.relpos_attn_probs.launches - before[0], AC.relpos_attn_ctx.launches) == (
        k1, before[1])
    assert (res.text, res.timestamps) == (text, stamps)
    online = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device="cuda")
    st = online.create_online_stream()
    st.add_samples(_pcm(6400))
    assert online.decode_to_end(st).text == online_text


def test_lstm_cudnn_equals_cpu(cuda):
    """The cuDNN recurrence (one flat weight buffer per layer) against
    ATen's loop on the CPU, from one numpy tree: float32 inside exact_f32()
    to atol 1e-5, bf16 to atol 0.05; the h and c carried by streaming steps
    likewise at float32."""
    cfg = TL.LstmConfig(d_model=64, rnn_hidden_size=160, num_layers=3, ff_dim=128, chunk_size=4)
    tree = TL.init_params(np.random.default_rng(2), cfg)
    encs = {dev: TL.Lstm(cfg, tree, dev) for dev in ("cpu", "cuda")}
    for w in encs["cuda"].rnn_weights(None) + encs["cuda"].rnn_weights(torch.bfloat16):
        assert len({x.untyped_storage().data_ptr() for x in w}) == 1  # one flat buffer
    x = np.random.default_rng(3).standard_normal((3, 131, 80)).astype(np.float32) * 0.5
    lens = np.array([131, 90, 40])
    out = {}
    for dev, enc in encs.items():
        with torch.inference_mode():
            with exact_f32():
                f32, _ = enc(torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev))
                state = enc.init_state(3)
                steps = []
                for i in range(3):
                    win = x[:, i * cfg.decode_chunk_len: i * cfg.decode_chunk_len
                            + cfg.chunk_input_len]
                    o, state = enc.streaming_step(state, torch.from_numpy(win).to(dev))
                    steps.append(o.cpu())
            bf16, _ = enc(torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev),
                          torch.bfloat16)
        out[dev] = (f32.cpu(), bf16.cpu(), steps, {k: v.cpu() for k, v in state.items()})
    (fg, bg, sg, stg), (fc, bc, sc, stc) = out["cuda"], out["cpu"]
    torch.testing.assert_close(fg, fc, atol=1e-5, rtol=0)
    torch.testing.assert_close(bg, bc, atol=0.05, rtol=0)
    for g, c in zip(sg, sc):
        torch.testing.assert_close(g, c, atol=1e-5, rtol=0)
    for key in ("h", "c"):
        torch.testing.assert_close(stg[key], stc[key], atol=1e-5, rtol=0)


# -- int8, ingest and the converter on the card ------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (17, 8, 8), (24, 16, 9), (40, 33, 64),
                                   (24, 64, 96), (125, 64, 96), (48, 96, 192),
                                   (5, 512, 1536), (3072, 1536, 512)])
def test_int8_matmul_on_the_card_equals_cpu(cuda, m, k, n):
    """torch._int_mm through int8_matmul's zero padding (few rows, K and N
    not multiples of 8) and a column slice of the weight, including shapes
    cuBLASLt refuses with a row-major weight (M not a multiple of 32, K <=
    96, N >= 32): the card's int32 product equals the CPU's exactly."""
    from k2transducerasr_tpu_torch.ops.layers import int8_matmul

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, 2 * n), dtype=np.int8))[:, n:]
    got = int8_matmul(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), int8_matmul(a, b))


def test_int8_quantization_on_the_card_is_bit_equal_to_cpu(cuda):
    """w_q8 and w_scale quantized on the card, and a linear's int8 output,
    equal the CPU's bit for bit (the scales divide by 127 correctly rounded
    on both)."""
    from k2transducerasr_tpu_torch.ops import layers as L

    rng = np.random.default_rng(8)
    p = {"w": torch.from_numpy((rng.standard_normal((512, 1536)) / 23).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(1536).astype(np.float32))}
    x = torch.from_numpy((3 * rng.standard_normal((500, 512))).astype(np.float32))
    q_cpu = L.quantize_linear_int8(p)
    q_gpu = L.quantize_linear_int8({k: v.cuda() for k, v in p.items()})
    for k in ("w_q8", "w_scale", "b"):
        assert torch.equal(q_gpu[k].cpu(), q_cpu[k]), k
    got = L.apply_linear(q_gpu, x.cuda()).cpu()
    torch.testing.assert_close(got, L.apply_linear(q_cpu, x), atol=1e-5, rtol=0)


# a small zipformer2 whose linears min_size=4096 quantizes (its pin dir has none)
INT8_Z2 = dict(num_encoder_layers=(1, 1), encoder_dims=(64, 96), downsampling_factors=(1, 2),
               num_heads=(2, 2), feedforward_dims=(128, 192), cnn_module_kernels=(7, 7),
               query_head_dim=8, value_head_dim=4, pos_head_dim=2, pos_dim=8,
               embed_channels=(2, 4, 8), causal=True, chunk_size=8, left_context_frames=16)


def _int8_bundle(family, dev):
    if family == "zipformer2":
        from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

        return ModelBundle.random("zipformer2", Zipformer2Config(**INT8_Z2), vocab_size=32,
                                  seed=3, decoder_dim=24, joiner_dim=20, device=dev)
    return ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device=dev)


@pytest.mark.parametrize("family", ["zipformer2", "conformer", "zipformer", "lstm"])
def test_int8_recognizers_on_the_card_equal_cpu(cuda, family):
    """accuracy="int8", float32: offline and online tokens and timestamps on
    the card equal the CPU's (the pin dirs of conformer, v1 and the LSTM; a
    small zipformer2 whose linears quantize)."""
    out = {}
    for dev in ("cpu", "cuda"):
        bundle = _int8_bundle(family, dev)
        rec = OfflineRecognizer(bundle, compute_dtype=None, accuracy="int8", device=dev)
        assert any(k.endswith(".w_q8") for k in rec.encoder.state_dict())
        s = rec.create_offline_stream()
        s.add_samples(_pcm(6400))
        r = rec.get_result(s)
        online = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, accuracy="int8",
                                  device=dev)
        st = online.create_online_stream()
        st.add_samples(_pcm(6400))
        o = online.decode_to_end(st)
        out[dev] = ((r.tokens, r.timestamps), (o.tokens, o.timestamps))
    assert out["cuda"] == out["cpu"] and out["cpu"][0][0]


def test_native_wav_route_equals_the_numpy_route(cuda, tmp_path):
    """A 44.1 kHz stereo wav read and resampled by the native library and by
    numpy decodes to the same tokens with the zipformer2 pin dir on the
    card."""
    import wave

    from k2transducerasr_tpu_torch import native
    from k2transducerasr_tpu_torch.audio import read_wav, resample_linear
    from k2transducerasr_tpu_torch.audio.wav import _decode_pcm

    if not native.available():
        pytest.skip("native toolchain (g++) unavailable")
    path = str(tmp_path / "a.wav")
    x = np.stack([_pcm(44100, 1), _pcm(44100, 2)], 1)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    audio = read_wav(path)
    with open(path, "rb") as f:
        assert np.array_equal(native.wav_decode(f.read())[0], audio.samples)
    routes = [native.resample_linear(audio.samples, 44100, 16000)]
    with wave.open(path) as w:
        routes.append(resample_linear(_decode_pcm(w.readframes(w.getnframes()), 2, 2),
                                      44100, 16000))
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
    res = []
    for pcm in routes:
        s = rec.create_offline_stream()
        s.add_samples(pcm)
        res.append(rec.get_result(s))
    assert (res[0].tokens, res[0].timestamps) == (res[1].tokens, res[1].timestamps)
    assert res[0].tokens


def test_converted_dir_decodes_on_the_card(cuda, tmp_path):
    """A zipformer2 bundle exported as a synthetic ONNX dir, converted, and
    loaded on the card decodes the source bundle's tokens, launching K1
    once per layer."""
    from k2transducerasr_tpu_torch.convert.importer import convert_model_dir, export_model_dir
    from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

    cfg = Zipformer2Config(**{k: v for k, v in INT8_Z2.items()
                              if k not in ("causal", "chunk_size", "left_context_frames")})
    src = ModelBundle.random("zipformer2", cfg, vocab_size=32, seed=4, decoder_dim=24,
                             joiner_dim=20, device="cuda")
    export_model_dir(src, str(tmp_path / "onnx"))
    convert_model_dir(str(tmp_path / "onnx"), str(tmp_path / "dir"))
    conv = ModelBundle.from_dir(str(tmp_path / "dir"), device="cuda")
    res = []
    for bundle in (src, conv):
        rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
        s = rec.create_offline_stream()
        s.add_samples(_pcm(6400))
        rec.get_result(s)  # captures the batch shape's graph
        before = AC.relpos_attn_probs.launches
        res.append(rec.get_result(s))
        assert AC.relpos_attn_probs.launches - before == sum(cfg.num_encoder_layers)
    assert (res[0].tokens, res[0].timestamps) == (res[1].tokens, res[1].timestamps)
    assert res[0].tokens


def _pin_wav(path):
    """The pin signal as a 16 kHz 16-bit wav of exact int16 samples."""
    import wave

    x = np.clip(np.round(_pcm(6400) * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x.tobytes())


CLI_PINS = {  # the zipformer2 pin dir's transcripts of the pin signal
    "offline": "tok25tok25tok18tok8tok12tok6tok25tok6",
    "online": "tok25tok25tok18tok8tok12tok6tok25tok6tok12tok6tok25tok6",
}


@pytest.mark.parametrize("args,pin", [
    (["-type", "offline", "-batch", "multi"], "offline"),
    (["-type", "offline", "-batch", "one", "-accuracy", "int8"], "offline"),
    (["-type", "online", "-batch", "multi"], "online"),
    (["-type", "online", "-batch", "one"], "online"),
], ids=["offline-multi", "offline-int8", "online-multi", "online-one"])
def test_cli_on_the_card_prints_the_pins(cuda, tmp_path, capsys, args, pin):
    """The CLI as shipped (bf16, the card by default) on the zipformer2 pin
    dir launches K1 and prints the pinned transcript."""
    from k2transducerasr_tpu_torch.cli.main import main

    _pin_wav(tmp_path / "pin.wav")
    before = AC.relpos_attn_probs.launches
    rc = main(["-base", os.path.join(PIN_ROOT, "zipformer2_pin"), "-files",
               str(tmp_path / "pin.wav"), *args])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[1] == CLI_PINS[pin] and lines[-1] == "end!"
    assert AC.relpos_attn_probs.launches > before


def test_cli_device_flag_on_the_card(cuda, tmp_path, capsys):
    """-device cpu and -device cuda print the same transcript lines."""
    from k2transducerasr_tpu_torch.cli.main import main

    _pin_wav(tmp_path / "pin.wav")
    outs = []
    for device in ("cpu", "cuda"):
        assert main(["-base", os.path.join(PIN_ROOT, "zipformer2_pin"), "-files",
                     str(tmp_path / "pin.wav"), "-device", device]) == 0
        outs.append(capsys.readouterr().out.splitlines()[:2])
    assert outs[0] == outs[1]


# -- the offline recognizer's CUDA graphs (runtime/program.py) ----------------

GREEDY, BEAM, CTC = "greedy_search", "modified_beam_search", "greedy_search_ctc"
SWOOSH, CONV_TF32 = 4, 5  # bias_swoosh's and conv_tf32's places in _counts()
# (family, method, hotwords): every family and search method on its pin dir
GRAPH_CASES = [("zipformer2", GREEDY, None), ("conformer", GREEDY, None),
               ("zipformer", GREEDY, None), ("lstm", GREEDY, None),
               ("zipformer2ctc", CTC, None), ("zipformer2", BEAM, None),
               ("conformer", BEAM, None), ("zipformer", BEAM, None), ("lstm", BEAM, None),
               ("zipformer2", BEAM, ["tok25tok25"])]
# under int8 (accuracy="int8", bf16): each family whose bundle quantizes
INT8_GRAPH_CASES = [("zipformer2", GREEDY), ("conformer", GREEDY), ("zipformer", GREEDY),
                    ("lstm", GREEDY), ("zipformer2", BEAM)]


def _counts():
    """Each counter of ``runtime/program.kernel_wrappers()``, in its order."""
    return (AC.relpos_attn_probs.launches, AC.relpos_attn_ctx.launches,
            TGreedy.greedy_frames_skip.launches, TBeam.beam_frames_skip.launches,
            ACT.bias_swoosh.launches, TLayers.conv_tf32.launches)


def _eager(rec, streams):
    """The batch through eager _decode (the graph's reference) and each
    kernel's launches in that run."""
    samples, counts = rec.pcm_batch(streams)
    before = _counts()
    with torch.inference_mode():
        out = rec._decode(samples, counts)
    return [t.cpu() for t in out], tuple(a - b for a, b in zip(_counts(), before))


def _assert_graph_equals_eager(rec, streams):
    """begin_decode of the batch (first the capture's replay, then a plain
    replay) reads back eager _decode's tokens, timestamps and counts, or its
    n-best, bit for bit, and a replay adds eager's launches to the counts."""
    want, launches = _eager(rec, streams)
    for _ in range(2):
        before = _counts()
        pending = rec.begin_decode(streams)
        pending.event.synchronize()
        assert len(pending.host) == len(want)
        for g, w in zip(pending.host, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert tuple(a - b for a, b in zip(_counts(), before)) == launches
    (entry,) = rec.program.entries.values()
    assert entry.graph is not None and entry.launches == launches
    return rec.end_decode(rec.begin_decode(streams))


def _ragged(rec, lens=(6400, 4100, 5300)):
    streams = []
    for i, n in enumerate(lens):
        s = rec.create_offline_stream()
        s.add_samples(_pcm(n, 9 + i))
        streams.append(s)
    return streams


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("family,method,hotwords", GRAPH_CASES,
                         ids=[f"{f}-{m}" + ("-hotwords" if h else "") for f, m, h in GRAPH_CASES])
def test_graph_equals_eager_decode(cuda, family, method, hotwords, compute_dtype):
    """Every family and search method, bf16 and float32: the graph's
    replay equals eager _decode on the same batch, bit for bit."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, decoding_method=method, compute_dtype=compute_dtype,
                            max_active_paths=4, hotwords=hotwords, device="cuda")
    results = _assert_graph_equals_eager(rec, _ragged(rec))
    assert any(r.tokens for r in results)


@pytest.mark.parametrize("family,method", INT8_GRAPH_CASES,
                         ids=[f"{f}-{m}" for f, m in INT8_GRAPH_CASES])
def test_graph_equals_eager_decode_under_int8(cuda, family, method):
    rec = OfflineRecognizer(_int8_bundle(family, "cuda"), decoding_method=method,
                            max_active_paths=4, accuracy="int8", device="cuda")
    assert any(k.endswith(".w_q8") for k in rec.encoder.state_dict())
    _assert_graph_equals_eager(rec, _ragged(rec))


@pytest.mark.parametrize("method", [GREEDY, BEAM])
def test_two_buckets_alternating_in_a_pipeline_equal_eager(cuda, method):
    """The memory policy (one pool for all of a recognizer's graphs, each
    replay's outputs cloned): batches of two buckets, 2-deep, in the order
    A, B, A, B: every handle equals eager _decode of its batch, though the
    other bucket's graph replayed after it was queued."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, decoding_method=method, max_active_paths=4,
                            frame_bucket=16, device="cuda")
    # 48-frame and 64-frame buckets at frame_bucket=16
    batches = [_ragged(rec, lens) for lens in ((6400, 5000), (9000, 8200), (6300, 5500),
                                               (8800, 9100))]
    want = [_eager(rec, b)[0] for b in batches]
    pending = [rec.begin_decode(batches[0])]
    for k in range(1, len(batches) + 1):
        if k < len(batches):
            pending.append(rec.begin_decode(batches[k]))
        pending[k - 1].event.synchronize()
        got = pending[k - 1].host
        assert all(torch.equal(g, w) for g, w in zip(got, want[k - 1])), f"batch {k - 1}"
    assert len(rec.program) == 2 and rec.program.pool_bytes() > 0


def test_begin_decode_on_a_second_stream_raises(cuda):
    """The graphs serve one caller stream, the one the first batch ran on:
    a begin_decode on another raises, and the first stream still decodes."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, device="cuda")
    streams = _ragged(rec)
    want = [r.tokens for r in rec.get_results(streams)]
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="one caller stream"):
            rec.begin_decode(streams)
    assert [r.tokens for r in rec.get_results(streams)] == want


def test_dropping_a_recognizer_releases_its_graph_pool(cuda):
    """With the cycle collector off, dropping a recognizer destroys its
    graphs: after empty_cache no segment of their pool is left."""
    import gc

    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, frame_bucket=16, device="cuda")
    rec.get_results(_ragged(rec))
    rec.get_results(_ragged(rec, (9000, 8200)))
    pool = tuple(rec.program.graphs.pool)
    assert len(rec.program) == 2 and rec.program.pool_bytes() > 0

    def pool_segments():
        return [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == pool]

    gc.disable()
    try:
        del rec
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert pool_segments() == []
    finally:
        gc.enable()


# -- the online recognizer's step graph (runtime/online.py::_step) ------------

# (family, method, hotwords): every family and search method on its pin dir
STEP_CASES = GRAPH_CASES
STEP_LANES = 3  # two streams and a lane no stream holds


def _pool_leaves(rec) -> list:
    """Every leaf of an online recognizer's lane pool (``_pool``), as it
    lies."""
    leaves = []
    tree_map(leaves.append, rec._pool())
    return leaves


def _step_pair(bundle, **kw):
    """Two recognizers of one bundle: the first steps through its graph, the
    second runs the same step function eagerly (its program taken away)."""
    graph = OnlineRecognizer(bundle, max_lanes=STEP_LANES, device="cuda", **kw)
    eager = OnlineRecognizer(bundle, max_lanes=STEP_LANES, device="cuda", **kw)
    eager.program = None
    return graph, eager


def _assert_step_graph_equals_eager(graph, eager):
    """Stream A holds 8 windows, stream B 4 and is passed to every other
    step only, the third lane holds no stream: half the lanes or more idle
    in every step.  After each step (the first, the capture's, included)
    the graph's pool equals the eager step's bit for bit, leaf by leaf, and
    so do the partial results; the lanes that took no window kept every
    leaf bit for bit; from the second step on a replay adds the eager
    step's launches.  Returns the last results."""
    win, hop = graph.window_samples, graph.hop_samples
    pcms = (_pcm(win + 7 * hop, 31), _pcm(win + 3 * hop, 32))
    pairs = []
    for rec in (graph, eager):
        pairs.append([rec.create_online_stream() for _ in pcms])
        for s, x in zip(pairs[-1], pcms):
            s.add_samples(x)
    results = []
    for step in range(8):
        picks = [[sa] + ([sb] if step % 2 == 0 else []) for sa, sb in pairs]
        stepping = {s.lane for s in picks[0] if s._ready()}
        before = [t.clone() for t in _pool_leaves(graph)]
        results, launches = [], []
        for rec, streams in zip((graph, eager), picks):
            c0 = _counts()
            results.append([(r.tokens, r.timestamps) for r in rec.get_results(streams)])
            launches.append(tuple(a - b for a, b in zip(_counts(), c0)))
        assert results[0] == results[1], f"step {step}"
        assert step == 0 or launches[0] == launches[1], f"step {step}"
        for g, e, old in zip(_pool_leaves(graph), _pool_leaves(eager), before):
            assert g.dtype == e.dtype and torch.equal(g, e), f"step {step}"
            for lane in set(range(STEP_LANES)) - stepping:
                assert torch.equal(g[lane], old[lane]), f"step {step}, idle lane {lane}"
    (entry,) = graph.program.entries.values()
    assert entry.graph is not None
    return results[0]


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("family,method,hotwords", STEP_CASES,
                         ids=[f"{f}-{m}" + ("-hotwords" if h else "") for f, m, h in STEP_CASES])
def test_step_graph_equals_eager_step(cuda, family, method, hotwords, compute_dtype):
    """Every family and search method, bf16 and float32: each step's replay
    leaves the pool the eager step leaves, bit for bit, idle lanes
    untouched, and the first step is not applied twice by the warm-up."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    graph, eager = _step_pair(bundle, decoding_method=method, compute_dtype=compute_dtype,
                              max_active_paths=4, hotwords=hotwords)
    assert any(tokens for tokens, _ in _assert_step_graph_equals_eager(graph, eager))


@pytest.mark.parametrize("family,method", INT8_GRAPH_CASES,
                         ids=[f"{f}-{m}" for f, m in INT8_GRAPH_CASES])
def test_step_graph_equals_eager_step_under_int8(cuda, family, method):
    graph, eager = _step_pair(_int8_bundle(family, "cuda"), decoding_method=method,
                              max_active_paths=4, accuracy="int8")
    _assert_step_graph_equals_eager(graph, eager)


def test_step_graph_two_windows_a_step_equal_one(cuda):
    """windows_per_step=2 through its graph gives the tokens of one window a
    step; each recognizer holds the one key (lanes, windows, samples)."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    results = {}
    for wps in (1, 2):
        graph, eager = _step_pair(bundle, windows_per_step=wps)
        results[wps] = _assert_step_graph_equals_eager(graph, eager)
        assert list(graph.program.entries) == [(STEP_LANES, wps, graph.window_samples)]
    assert results[2] == results[1]


def test_step_graph_with_dither_equals_the_per_call_draw(cuda):
    """With dither the graph reads the noise its recognizer drew once; the
    eager step, whose fbank draws its seed-0 noise on every call, leaves
    the same pool and results bit for bit."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    bundle = dataclasses.replace(bundle, frontend_cfg=dataclasses.replace(bundle.frontend_cfg,
                                                                          dither=0.01))
    graph, eager = _step_pair(bundle)
    eager._dither = None
    assert any(tokens for tokens, _ in _assert_step_graph_equals_eager(graph, eager))


def test_step_graph_pool_never_moves_and_serves_one_stream(cuda):
    """The pool's leaves keep their storage across steps, a lane's reset and
    restore_stream, and the recognizer keeps one graph; a begin_step on
    another stream raises, and the first stream still steps."""
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OnlineRecognizer(bundle, max_lanes=STEP_LANES, device="cuda")
    ptrs = [t.data_ptr() for t in _pool_leaves(rec)]
    s = rec.create_online_stream()
    s.add_samples(_pcm(rec.window_samples + 3 * rec.hop_samples, 33))
    rec.get_results([s])
    snap = rec.snapshot_stream(s)
    rec.dispose_stream(s)
    again = rec.create_online_stream()
    again.add_samples(_pcm(rec.window_samples, 34))
    rec.get_results([again])
    restored = rec.restore_stream(snap)
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="one caller stream"):
            rec.begin_step([restored])
    assert rec.decode_to_end(restored).tokens
    assert [t.data_ptr() for t in _pool_leaves(rec)] == ptrs and len(rec.program) == 1


# -- bias + Swoosh (ops/activations_cuda.py) ---------------------------------

# (name, shape as the encoder hands it over, how it lies in memory, in dtype,
# out dtype, bias, kind).  First the cells' shapes: longform's 20 x 30 s
# batch (1496 encoder-rate frames at stack 0, 187 at stack 3, 1496 stage
# frames of 19 bins out of the ConvNeXt, 2998 x 80 after embed conv1) and
# offpeak's 820 lanes x 32 frames; the layouts are the products' rows, a
# depthwise convolution's [B, C, T] and an NCHW convolution's, each seen
# channels last.  Then ragged channels and unaligned pointers.
F32, BF16 = torch.float32, torch.bfloat16
SWOOSH_CASES = [
    ("ff-stack0", (20 * 1496, 512), "rows", BF16, BF16, True, "l"),
    ("ff-stack3", (20 * 187, 1536), "rows", BF16, BF16, True, "l"),
    ("convnext-pw1", (20, 1496, 19, 384), "rows", BF16, BF16, True, "l"),
    ("conv-module", (20, 1496, 192), "depthwise", F32, BF16, True, "r"),
    ("conv-module-stack3", (20, 187, 512), "depthwise", F32, BF16, True, "r"),
    ("embed-conv1", (20, 2998, 80, 8), "nchw", F32, BF16, True, "r"),
    ("embed-conv3", (20, 1497, 19, 128), "nchw", F32, BF16, True, "r"),
    ("stream-ff", (820 * 32, 512), "rows", BF16, BF16, True, "l"),
    ("stream-conv-sum", (820, 32, 192), "rows", F32, BF16, False, "r"),
    ("f32", (4096, 384), "rows", F32, F32, True, "l"),
    ("f32-depthwise", (8, 77, 192), "depthwise", F32, F32, True, "r"),
    ("int8-ff", (640, 768), "rows", F32, BF16, True, "l"),
    ("ragged-c", (7, 13), "rows", BF16, BF16, True, "r"),
    ("ragged-c-f32", (7, 13), "rows", F32, F32, False, "l"),
    ("unaligned", (33, 64), "offset", BF16, BF16, True, "l"),
    ("unaligned-f32", (33, 64), "offset", F32, BF16, True, "r"),
]


def _swoosh_input(shape, layout, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    flat = (torch.randn(n + 1, generator=g, device="cuda") * 5).to(dtype)
    if layout == "rows":
        return flat[:n].view(shape)
    if layout == "offset":  # 2 or 4 bytes past a 16-byte boundary
        return flat[1:].view(shape)
    if layout == "depthwise":  # [B, C, T] seen as [B, T, C]
        b, t, c = shape
        return flat[:n].view(b, c, t).transpose(1, 2)
    b, h, w, c = shape  # NCHW seen as NHWC
    return flat[:n].view(b, c, h, w).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name,shape,layout,dtype,out_dtype,bias,kind", SWOOSH_CASES,
                         ids=[c[0] for c in SWOOSH_CASES])
def test_bias_swoosh_matches_plain(cuda, name, shape, layout, dtype, out_dtype, bias, kind):
    y = _swoosh_input(shape, layout, dtype, seed=len(name))
    b = torch.randn(shape[-1], device="cuda") if bias else None
    before = ACT.bias_swoosh.launches
    got = ACT.bias_swoosh(y, b, kind, out_dtype)
    torch.cuda.synchronize()
    assert ACT.bias_swoosh.launches == before + 1
    assert got.dtype == out_dtype and got.shape == y.shape and got.stride() == y.stride()
    want = ACT.bias_swoosh_reference(y, b, kind, out_dtype)
    d = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(torch.finfo(out_dtype).tiny)
    ulps, bits = (1, 7) if out_dtype == BF16 else (2, 23)
    ok = d <= ulps * torch.exp2(torch.floor(torch.log2(mag)) - bits)
    assert bool(ok.all()), f"{int((~ok).sum())} of {d.numel()} past {ulps} ulp, max {d.max()}"


@pytest.mark.parametrize("route", ["offline", "streaming"])
def test_graph_replay_counts_84_bias_swoosh_launches(cuda, route):
    """At the flagship's widths and 16 layers, a captured offline graph and
    a captured streaming step each add 84 bias_swoosh launches a replay (48
    feed-forwards, 32 conv modules, 3 embed convs, the ConvNeXt), as many
    as one eager run of the offline batch launches."""
    from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=route == "streaming"),
                                vocab_size=500, seed=5, device="cuda")
    if route == "offline":
        rec = OfflineRecognizer(bundle, device="cuda")
        s = rec.create_offline_stream()
        s.add_samples(_pcm(5 * 16000))
        assert _eager(rec, [s])[1][SWOOSH] == 84
        rec.get_result(s)  # captures the batch shape's graph
        before = ACT.bias_swoosh.launches
        rec.get_result(s)
    else:
        rec = OnlineRecognizer(bundle, max_lanes=4, device="cuda")
        s = rec.create_online_stream()
        s.add_samples(_pcm(rec.window_samples + 4 * rec.hop_samples))
        rec.get_results([s])  # the first step: warm-up on the idle pool, capture, replay
        before = ACT.bias_swoosh.launches
        rec.get_results([s])
    assert ACT.bias_swoosh.launches - before == 84
    (entry,) = rec.program.entries.values()
    assert entry.launches[SWOOSH] == 84


# -- the convolutions on the tensor cores (ops/layers.py::conv_tf32) ----------

# (name, x [B, H, W, C_in] or [B, T, C_in], weight HWIO or [K, C_in, C_out],
# arguments): every convolution of the benchmark cells' encoders but the
# depthwise ones, at the cells' shapes: conf_offline_longform's and
# z2_offline_longform's 20 x 30 s (3,072 fbank frames, 767 after the
# conformer's embed), z2_stream_offpeak's step over 820 lanes (77 frames)
CONV_CASES = [
    ("conformer-embed-conv1", (20, 3072, 80, 1), (3, 3, 1, 512), dict(strides=(2, 2))),
    ("conformer-embed-conv2", (20, 1535, 39, 512), (3, 3, 512, 512), dict(strides=(2, 2))),
    ("conformer-pointwise1", (20, 767, 512), (1, 512, 1024), dict(padding="SAME")),
    ("conformer-pointwise2", (20, 767, 512), (1, 512, 512), dict(padding="SAME")),
    ("z2-longform-embed-conv1", (20, 3072, 80, 1), (3, 3, 1, 8), dict(padding=(0, 1))),
    ("z2-longform-embed-conv2", (20, 3070, 80, 8), (3, 3, 8, 32), dict(strides=(2, 2))),
    ("z2-longform-embed-conv3", (20, 1534, 39, 32), (3, 3, 32, 128), dict(strides=(1, 2))),
    ("z2-offpeak-embed-conv1", (820, 77, 80, 1), (3, 3, 1, 8), dict(padding=(0, 1))),
    ("z2-offpeak-embed-conv2", (820, 75, 80, 8), (3, 3, 8, 32), dict(strides=(2, 2))),
    ("z2-offpeak-embed-conv3", (820, 37, 39, 32), (3, 3, 32, 128), dict(strides=(1, 2))),
]


@pytest.mark.parametrize("name,xs,ws,kw", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_bf16_conv_product_is_the_float32_conv_up_to_summation_order(cuda, name, xs, ws, kw):
    """A bf16-operand product (on the tensor cores where ``conv_tf32``
    scopes it: 32 output channels or more) against the same product in
    true float32 (``exact_f32``, FFMA) over the bf16-rounded operands, within
    (K + 2) x 2^-23 x the conv of |x| and |w|, K = C_in x kh x kw: the
    float32 summation-order bound, since every product of two bf16 values
    is exact in both.  ``conv_tf32.launches`` rises by one where the product
    is scoped, and the process's flag (off) is left as it was."""
    g = torch.Generator(device="cuda").manual_seed(len(name))
    x = torch.randn(xs, generator=g, device="cuda")
    w = torch.randn(ws, generator=g, device="cuda") * ws[-2] ** -0.5
    product = TLayers.conv1d_product if len(xs) == 3 else TLayers.conv2d_product
    scoped = ws[-1] >= TLayers.TF32_MIN_OUT_CHANNELS
    before = TLayers.conv_tf32.launches
    got = product(w, x, compute_dtype=torch.bfloat16, **kw)
    assert TLayers.conv_tf32.launches - before == int(scoped)
    assert torch.backends.cudnn.allow_tf32 is False and got.dtype == torch.float32
    xr, wr = x.bfloat16().float(), w.bfloat16().float()
    del x, w
    with exact_f32():
        want = product(wr, xr, **kw)
        mag = product(wr.abs(), xr.abs(), **kw)
    k = ws[0] * ws[-2] * (ws[1] if len(ws) == 4 else 1)
    err = (got - want).abs()
    limit = (k + 2) * 2.0**-23 * mag
    assert bool((err <= limit).all()), f"max err {err.max().item():.3e} past the bound"


@pytest.mark.parametrize("name,xs,ws,kw", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_bf16_conv_product_is_f_conv_under_the_tf32_it_asks_for(cuda, name, xs, ws, kw):
    """The scoped route (``aten::cudnn_convolution`` with ``allow_tf32``
    passed in, the flag untouched) makes the call ``F.conv1d``/``F.conv2d``
    makes: bit for bit the same product over the bf16-rounded operands with
    ``cudnn.allow_tf32`` set True around it here; an unscoped product (8
    outputs) the same with the flag off, as the process has it."""
    g = torch.Generator(device="cuda").manual_seed(len(name))
    x = torch.randn(xs, generator=g, device="cuda")
    w = torch.randn(ws, generator=g, device="cuda") * ws[-2] ** -0.5
    product = TLayers.conv1d_product if len(xs) == 3 else TLayers.conv2d_product
    scoped = ws[-1] >= TLayers.TF32_MIN_OUT_CHANNELS
    got = product(w, x, compute_dtype=torch.bfloat16, **kw)
    assert torch.backends.cudnn.allow_tf32 is False
    xr, wr = x.bfloat16().float(), w.bfloat16().float()
    del x, w
    torch.backends.cudnn.allow_tf32 = scoped
    try:
        want = product(wr, xr, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert got.shape == want.shape and torch.equal(got, want)


def test_float32_convs_on_another_thread_stay_float32_while_scoped_ones_run(cuda):
    """One thread runs scoped bf16-operand convolutions in a loop while
    another runs float32 ones (float32 operands, which TF32 would round)
    inside ``exact_f32``: every float32 result equals the float32 product
    run alone, bit for bit.  A scope that turned the process's TF32 flag on
    would let some of them run on TF32."""
    import threading

    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((64, 200, 80, 8), generator=g, device="cuda")
    w = torch.randn((3, 3, 8, 32), generator=g, device="cuda") * 8 ** -0.5
    with exact_f32():
        alone = TLayers.conv2d_product(w, x, strides=(2, 2))
    torch.cuda.synchronize()
    stop, errors, mismatches = threading.Event(), [], []
    scoped = [0]

    def bf16_loop():
        try:
            while not stop.is_set():
                TLayers.conv2d_product(w, x, strides=(2, 2), compute_dtype=torch.bfloat16)
                scoped[0] += 1
        except Exception as e:  # reported below
            errors.append(e)

    def float32_loop():
        try:
            for _ in range(200):
                with exact_f32():
                    got = TLayers.conv2d_product(w, x, strides=(2, 2))
                if not torch.equal(got, alone):
                    mismatches.append((got - alone).abs().max().item())
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            stop.set()

    threads = [threading.Thread(target=f) for f in (bf16_loop, float32_loop)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    torch.cuda.synchronize()
    assert errors == [] and scoped[0] > 0
    assert mismatches == [], f"{len(mismatches)} of 200 float32 convs left float32"
    assert torch.backends.cudnn.allow_tf32 is False


# (family, route, compute dtype, conv_tf32 calls a replay)
CONV_COUNT_CASES = [("conformer", "offline", torch.bfloat16, 26),
                    ("zipformer2", "offline", torch.bfloat16, 2),
                    ("zipformer2", "streaming", torch.bfloat16, 2),
                    ("conformer", "offline", None, 0)]


@pytest.mark.parametrize("flag", [False, True], ids=["tf32-off", "tf32-on"])
@pytest.mark.parametrize("family,route,compute_dtype,want", CONV_COUNT_CASES,
                         ids=[f"{f}-{r}-{'bf16' if c else 'f32'}"
                              for f, r, c, _ in CONV_COUNT_CASES])
def test_graph_replay_counts_conv_tf32_calls_and_leaves_the_flag(cuda, flag, family, route,
                                                                 compute_dtype, want):
    """At full width a captured offline graph or streaming step adds its
    scoped convolutions to ``conv_tf32.launches`` at each replay: 26 a
    conformer batch (the embed's two convs, 12 layers' two pointwise
    convs), 2 a zipformer2 batch or step (the embed's conv2 and conv3; conv1
    has 8 outputs), 0 on the float32 route.  ``torch.backends.cudnn.
    allow_tf32`` reads as the process set it, off or on, after the eager
    run, the warm-up and capture, and a replay."""
    from k2transducerasr_tpu_torch.models.conformer import ConformerConfig
    from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config

    torch.backends.cudnn.allow_tf32 = flag
    config = {"conformer": ConformerConfig, "zipformer2": Zipformer2Config}[family]
    bundle = ModelBundle.random(family, config(causal=route == "streaming"), vocab_size=500,
                                seed=5, device="cuda")
    if route == "offline":
        rec = OfflineRecognizer(bundle, compute_dtype=compute_dtype, device="cuda")
        s = rec.create_offline_stream()
        s.add_samples(_pcm(5 * 16000))
        assert _eager(rec, [s])[1][CONV_TF32] == want
        assert torch.backends.cudnn.allow_tf32 is flag
        rec.get_result(s)  # the warm-up, the capture and a replay
        assert torch.backends.cudnn.allow_tf32 is flag
        before = TLayers.conv_tf32.launches
        rec.get_result(s)
    else:
        rec = OnlineRecognizer(bundle, compute_dtype=compute_dtype, max_lanes=4, device="cuda")
        s = rec.create_online_stream()
        s.add_samples(_pcm(rec.window_samples + 4 * rec.hop_samples))
        rec.get_results([s])  # the first step: warm-up on the idle pool, capture, replay
        assert torch.backends.cudnn.allow_tf32 is flag
        before = TLayers.conv_tf32.launches
        rec.get_results([s])
    assert torch.backends.cudnn.allow_tf32 is flag
    assert TLayers.conv_tf32.launches - before == want
    (entry,) = rec.program.entries.values()
    assert entry.launches[CONV_TF32] == want


def test_capture_refusal_raises_and_never_decodes_eagerly(cuda, monkeypatch):
    """A host read planted in _decode: the warm-up runs it, the capture
    refuses it, and begin_decode raises with no graph kept and no result.
    (Last in the file: a refused capture is left to PyTorch to end.)"""
    from k2transducerasr_tpu_torch.runtime import offline as offline_mod

    decode = offline_mod.OfflineRecognizer._decode

    def planted(self, samples, sample_counts):
        out = decode(self, samples, sample_counts)
        out[2].sum().item()  # waits for the card: not capturable
        return out

    monkeypatch.setattr(offline_mod.OfflineRecognizer, "_decode", planted)
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, device="cuda")
    streams = _ragged(rec)
    with pytest.raises(RuntimeError):
        rec.begin_decode(streams)
    assert len(rec.program) == 0


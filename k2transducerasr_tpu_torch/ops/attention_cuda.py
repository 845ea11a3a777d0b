"""Relative-position attention kernels — the CUDA counterparts of
``k2transducerasr_tpu/ops/attention_pallas.py``:

    K1  relpos_attn_probs:  probs = softmax(mask(q @ k^T + rel_shift(pos_q @ pos_k^T)))
                            [B, H, T, S]            (csrc/relpos_attn_probs.cu)
    K2  relpos_attn_ctx:    ctx = probs @ v          [B, T, H, vd]
                            (csrc/relpos_attn_ctx.cu; no [T, S] tensor is written)

Each wrapper launches its hand-written Hopper kernel for CUDA tensors and
runs its plain PyTorch version (``*_reference``, the same function) for CPU
tensors.  On a CUDA tensor it launches the kernel or raises; there is no
fallback.  The kernels are compiled with ``nvcc`` at first use
(``ops/cuda_build.py``) and loaded with ctypes, so importing this module
needs neither ``nvcc`` nor a card.  Both plain versions share one
masked-scores body, as the TPU kernels share ``_masked_scores``.

Masks are key-side only, as in the TPU kernels: ``s < min(lens[b], S)``,
``s >= kv_start[b]``, and the static chunk window (``chunk``/``left``; needs
T == S).  Invalid query rows therefore differ from a query+key mask
(``mask_from_specs``); every caller zeroes those rows downstream.

``relpos_attn_probs.launches`` and ``relpos_attn_ctx.launches`` count kernel
launches (the CPU path does not count), so a run can show that the main path
went through the kernels.  A CUDA graph's replay runs no Python: the graph's
program (``runtime/program.py``) adds the launches it captured to these
counts at each replay, and takes back those its capture made.

Two bodies per kernel, chosen by the operands' dtype inside one C entry
point: bf16 inputs run on the tensor cores around one shared score tile
(``csrc/relpos_scores.cuh``), float32 inputs on the CUDA cores (tensor
cores would round them to TF32; its output is float32, cast by the wrapper
when a bf16 output is asked for).

Limits: both kernels, in both bodies, tile the key axis and take any S.
Heads of up to 64 (qd, pd and K2's vd) run each body's one-chunk form;
wider heads run its chunked form, which sums the scores over 64-wide
chunks of the head (and K2's P.V over 64-wide column tiles of v), up to
``MAX_HEAD`` = 512: the bf16 chunked bodies keep every chunk of their 64
query rows in shared memory, 9 KB per chunk.  Wider heads raise
ValueError.
"""

from __future__ import annotations

import ctypes

import torch

from k2transducerasr_tpu_torch.ops import cuda_build
from k2transducerasr_tpu_torch.ops.attention import chunk_causal_mask, rel_shift
from k2transducerasr_tpu_torch.ops.layers import NEG_INF, length_mask

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 512  # both kernels' widest q, pos and (K2) value heads, in both bodies
_CHUNK = 64  # heads up to this run the one-chunk forms; K1's float32 one
# keeps its q and pos rows this wide in shared memory
_ROWS = 8  # K1's float32 body: query rows per block (one warp each)
_KEY_TILE = 256  # K1's float32 body: keys per tile (one per thread)

_PROBS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_CTX_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _probs_max_widths(dtype) -> tuple[int, int]:
    """K1's widest (qd, pd) for inputs of ``dtype`` (either body)."""
    return MAX_HEAD, MAX_HEAD


def _probs_rows(dtype, t: int) -> int:
    """K1's ``rows`` argument: 0 for bf16 (the tensor-core body's rows are
    fixed), else the float32 body's query rows per block, ``_ROWS`` or T
    when shorter.  Its shared memory holds one tile of keys
    (``_smem_bytes``; the chunked form's pos rows 64 columns at a time), so
    neither S nor pd changes the rows."""
    return 0 if dtype == torch.bfloat16 else min(_ROWS, t)


def _smem_bytes(rows: int, pd: int) -> int:
    # must match smem_bytes() in csrc/relpos_attn_probs.cu (heads up to 64)
    pd4 = -(-pd // 4) * 4
    return 4 * (rows * _CHUNK + rows * _CHUNK + (_KEY_TILE + rows - 1) * pd4
                + rows * _KEY_TILE)


def _check_contract(q, k, pos_q, pos_k, chunk, v=None):
    b, t, h = q.shape[:3]
    s = k.shape[1]
    r = pos_k.shape[0]
    # ValueError (not assert): a mismatch would silently misalign positions
    if r != t + s - 1:
        raise ValueError(f"pos_k rows {r} != t+s-1 ({t}+{s}-1)")
    if chunk and t != s:
        raise ValueError(f"chunk-causal requires t == s, got t={t} s={s}")
    if v is not None and tuple(v.shape[:3]) != (b, s, h):
        raise ValueError(f"v shape {tuple(v.shape)} != {(b, s, h, v.shape[-1])}")


def _check_operands(name_to_tensor: dict, q, out_dtype):
    """Device, dtype and contiguity of a kernel's operands."""
    for name, x in name_to_tensor.items():
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes must be float32/bfloat16, got {q.dtype} -> {out_dtype}")


def _check_shapes(q, k, pos_q, pos_k, v=None):
    b, t, h, qd = q.shape
    s = k.shape[1]
    pd = pos_q.shape[-1]
    if (k.shape != (b, s, h, qd) or pos_q.shape != (b, t, h, pd) or pos_k.shape[1:] != (h, pd)
            or (v is not None and v.dim() != 4)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"pos_q {tuple(pos_q.shape)} pos_k {tuple(pos_k.shape)}"
            + ("" if v is None else f" v {tuple(v.shape)}")
        )
    if min(b, t, s, h) == 0:
        raise ValueError(f"empty attention (B={b} T={t} S={s} H={h})")


def relpos_attn_probs(q, k, pos_q, pos_k, lens, out_dtype=None, chunk: int = 0,
                      left: int = 0, kv_start=None):
    """K1: fused softmax(q@k^T + rel_shift(pos_q@pos_k^T)) with key-side masks.

    q:     [B, T, H, qd]   queries
    k:     [B, S, H, qd]   keys
    pos_q: [B, T, H, pd]   position-query projections
    pos_k: [R, H, pd]      projected rel-pos table, R = T+S-1, descending
                           relative positions
    lens:  [B] int         valid key counts (None = all S valid)
    chunk/left:            static chunk-causal pattern (requires T == S):
                           query t attends keys in
                           [(t//chunk)*chunk - left, (t//chunk)*chunk + chunk)
    kv_start: [B] int      first valid key column per lane
    Returns probs [B, H, T, S] in ``out_dtype`` (default: q.dtype).
    """
    _check_contract(q, k, pos_q, pos_k, chunk)
    if q.device.type == "cpu":
        return relpos_attn_probs_reference(q, k, pos_q, pos_k, lens, out_dtype, chunk, left,
                                           kv_start)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attn_probs: unsupported device {q.device}")

    b, t, h, qd = q.shape
    s = k.shape[1]
    pd = pos_q.shape[-1]
    out_dtype = out_dtype or q.dtype
    _check_operands({"q": q, "k": k, "pos_q": pos_q, "pos_k": pos_k}, q, out_dtype)
    _check_shapes(q, k, pos_q, pos_k)
    max_qd, max_pd = _probs_max_widths(q.dtype)
    if qd > max_qd or pd > max_pd:
        raise ValueError(f"kernel takes qd <= {max_qd} and pd <= {max_pd} for {q.dtype}, "
                         f"got {qd}, {pd}")
    lens = _lane_ints(lens, b, q.device)
    kv_start = _lane_ints(kv_start, b, q.device)
    rows = _probs_rows(q.dtype, t)

    # the float32 body writes float32 (its first pass stores the raw scores)
    kernel_dtype = out_dtype if q.dtype == torch.bfloat16 else torch.float32
    out = torch.empty((b, h, t, s), dtype=kernel_dtype, device=q.device)
    fn = cuda_build.function("relpos_attn_probs", "k2t_relpos_attn_probs", _PROBS_ARGTYPES)
    cuda_build.launch("relpos_attn_probs", fn, q.device,
            q.data_ptr(), k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
            _ptr(lens), _ptr(kv_start), out.data_ptr(),
            b, t, s, h, qd, pd, int(chunk), int(left), rows,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[kernel_dtype])
    relpos_attn_probs.launches += 1
    return out.to(out_dtype)


relpos_attn_probs.launches = 0


def relpos_attn_ctx(q, k, pos_q, pos_k, v, lens, out_dtype=None, chunk: int = 0,
                    left: int = 0, kv_start=None):
    """K2: softmax(mask(q@k^T + rel_shift(pos_q@pos_k^T))) @ v, the probs
    never written out.  Same inputs and masks as ``relpos_attn_probs``, plus

    v:     [B, S, H, vd]   per-head values (vd may differ from qd)
    Returns ctx [B, T, H, vd] in ``out_dtype`` (default: q.dtype).

    Rounding: the kernel's softmax is online.  With bf16 inputs it rounds the
    UNNORMALISED probabilities to bf16 before the product with v and divides
    by the row sum last; the plain version rounds the normalised ones, as the
    TPU kernel does, so the two differ by at most 2^-8 * max|v| before the
    output's own rounding.  With float32 inputs the kernel keeps the
    probabilities in float32: the same function up to summation order.  See
    the note in ``csrc/relpos_attn_ctx.cu``.
    """
    _check_contract(q, k, pos_q, pos_k, chunk, v)
    if q.device.type == "cpu":
        return relpos_attn_ctx_reference(q, k, pos_q, pos_k, v, lens, out_dtype, chunk, left,
                                         kv_start)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attn_ctx: unsupported device {q.device}")

    b, t, h, qd = q.shape
    s = k.shape[1]
    pd = pos_q.shape[-1]
    vd = v.shape[-1]
    out_dtype = out_dtype or q.dtype
    _check_operands({"q": q, "k": k, "pos_q": pos_q, "pos_k": pos_k, "v": v}, q, out_dtype)
    _check_shapes(q, k, pos_q, pos_k, v)
    if max(qd, pd, vd) > MAX_HEAD:
        raise ValueError(f"kernel takes qd, pd and vd <= {MAX_HEAD}, got {qd}, {pd}, {vd}")
    lens = _lane_ints(lens, b, q.device)
    kv_start = _lane_ints(kv_start, b, q.device)

    out = torch.empty((b, t, h, vd), dtype=out_dtype, device=q.device)
    fn = cuda_build.function("relpos_attn_ctx", "k2t_relpos_attn_ctx", _CTX_ARGTYPES)
    cuda_build.launch("relpos_attn_ctx", fn, q.device,
            q.data_ptr(), k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(), v.data_ptr(),
            _ptr(lens), _ptr(kv_start), out.data_ptr(),
            b, t, s, h, qd, pd, vd, int(chunk), int(left),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype])
    relpos_attn_ctx.launches += 1
    return out


relpos_attn_ctx.launches = 0


def _lane_ints(x, b: int, device) -> torch.Tensor | None:
    """[B] int32 contiguous on ``device``; None stays None (the kernels read a
    null ``lens`` as all S keys valid and a null ``kv_start`` as 0)."""
    if x is None:
        return None
    x = torch.as_tensor(x)
    if x.shape != (b,):
        raise ValueError(f"per-lane tensor shape {tuple(x.shape)} != ({b},)")
    if x.device != device:
        raise ValueError(f"per-lane tensor on {x.device}, expected {device}")
    return x.to(torch.int32).contiguous()


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _masked_scores(q, k, pos_q, pos_k, lens, chunk: int, left: int, kv_start):
    """Float32 scores [B, H, T, S] = q.k + skewed pos_q.pos_k, NEG_INF at the
    masked keys — the body both plain versions share."""
    b, t = q.shape[:2]
    s = k.shape[1]
    dev = q.device
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    pos_full = torch.einsum("bthd,rhd->bhtr", pos_q.float(), pos_k.float())
    scores = scores + rel_shift(pos_full, s)
    col = torch.arange(s, device=dev)
    limit = torch.full((b,), s, device=dev) if lens is None else torch.clamp(lens.to(dev), max=s)
    valid = col[None, :] < limit[:, None]  # [B, S]
    if kv_start is not None:
        valid = valid & (col[None, :] >= kv_start.to(dev)[:, None])
    valid = valid[:, None, None, :]  # [B, 1, 1, S]
    if chunk:
        valid = valid & chunk_causal_mask(t, chunk, left, dev)[None, None]
    return torch.where(valid, scores, NEG_INF)


def relpos_attn_probs_reference(q, k, pos_q, pos_k, lens, out_dtype=None, chunk: int = 0,
                                left: int = 0, kv_start=None):
    """Plain PyTorch version of ``relpos_attn_probs`` (same contract): float32
    scores and softmax, key-side masks, cast to ``out_dtype`` at the end."""
    _check_contract(q, k, pos_q, pos_k, chunk)
    scores = _masked_scores(q, k, pos_q, pos_k, lens, chunk, left, kv_start)
    return torch.softmax(scores, dim=-1).to(out_dtype or q.dtype)


def relpos_attn_ctx_reference(q, k, pos_q, pos_k, v, lens, out_dtype=None, chunk: int = 0,
                              left: int = 0, kv_start=None):
    """Plain PyTorch version of ``relpos_attn_ctx`` (same contract): the
    float32 probs of ``relpos_attn_probs_reference``, rounded to v's dtype,
    times v with float32 accumulation, cast to ``out_dtype`` — the TPU
    kernel's ``einsum("bhts,bshd->bthd", probs.astype(v.dtype), v)``."""
    _check_contract(q, k, pos_q, pos_k, chunk, v)
    scores = _masked_scores(q, k, pos_q, pos_k, lens, chunk, left, kv_start)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    ctx = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return ctx.to(out_dtype or q.dtype)


def mask_from_specs(b: int, t: int, s: int, pad_lens=None, chunk_left=None, kv_start=None):
    """Boolean mask [B, T, S] equivalent to the mask specs of the reference's
    XLA path: ``pad_lens`` adds the query+key padding mask (the kernel masks
    only keys — the difference lives on invalid query rows, which callers
    zero), ``chunk_left`` the static chunk-causal pattern (T == S),
    ``kv_start`` per-lane first-valid-column gating.  None if no spec."""
    lane = pad_lens if pad_lens is not None else kv_start
    dev = lane.device if lane is not None else None
    mask = None
    if pad_lens is not None:
        mask = length_mask(pad_lens, s)[:, None, :] & length_mask(pad_lens, t)[:, :, None]
    if chunk_left is not None:
        cmask = chunk_causal_mask(t, chunk_left[0], chunk_left[1], dev)[None]
        mask = cmask if mask is None else (mask & cmask)
    if kv_start is not None:
        smask = (torch.arange(s, device=dev)[None, None, :]
                 >= kv_start[:, None, None]).expand(b, t, s)
        mask = smask if mask is None else (mask & smask)
    return mask

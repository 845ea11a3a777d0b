"""Batched RNN-T greedy search — PyTorch port of
``k2transducerasr_tpu/decode/rnnt_greedy.py``.

``greedy_frames_skip`` is the production path.  The reference runs it as
one ``lax.while_loop`` on the device; here, for CUDA tensors, it is one
launch of a hand-written kernel (``csrc/rnnt_greedy.cu``) that runs each
lane's whole search on the card, so a caller that queues it does not wait.
For CPU tensors it runs ``greedy_frames_skip_reference``, the plain
version: each trip evaluates the joiner over a window of frames for every
lane, emits at each lane's first non-blank argmax, refreshes the decoder,
and moves that lane's frame pointer past the emission, with one host sync
per trip (the loop condition).  ``greedy_frames`` (one step per frame) is
the oracle both are tested against; the result does not depend on the
window.

Semantics (as the reference): blank=0, sos/eos=1, unk=2; emission skips
{blank, unk} (and 1 with ``extra_skip_sos``); max one symbol per frame;
timestamps are emission frame indices (+ ``frame_offset``); lanes past their
``enc_lens`` or with a full token buffer do not emit.  The token buffers are
updated in place (the reference's functional ``.at[].set``) on copies of
the state's.

``greedy_operands`` builds the kernel's operands from the decoder and
joiner (the folded context tables, the weights in the kernel's layouts);
a recognizer builds them once and passes them to every call.  The kernel
runs each lane on a cluster of ``CLUSTER`` blocks; block r owns the
``rank_ranges`` share r of W_out's 8-column n-tiles and of decoder_proj's
8-column chunks, and both weights are laid out unit-major so that every
share is one contiguous range of the packed operand (rows lo .. hi of
``out_w`` and ``dec_w``).
``k2transducerasr_tpu_torch.testing.tie_aware_replay`` holds a bf16 search
to the plain ops frame by frame.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.ops import cuda_build

_UNK = 2
CLUSTER = 8  # blocks per lane (kCL)
_DTYPE_CODE = {None: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]
# what k2t_rnnt_greedy_plan and k2t_rnnt_beam_plan report, in order
PLAN_KEYS = ("smem_bytes", "resident_ntiles", "resident_chunks", "stage_ntiles",
             "stage_chunks", "ntiles_per_rank", "chunks_per_rank", "max_active_clusters",
             "registers", "local_bytes", "ring_stages")


@dataclasses.dataclass
class GreedyState:
    hyp: torch.Tensor  # [B, context_size] int64 — last context tokens
    dec_proj: torch.Tensor  # [B, joiner_dim] — projected decoder output for hyp
    tokens: torch.Tensor  # [B, K] int64 — emitted tokens
    timestamps: torch.Tensor  # [B, K] int64 — emission frame index
    count: torch.Tensor  # [B] int64 — number of emitted tokens
    trailing_blanks: torch.Tensor  # [B] int64 — consecutive blank frames


def init_state(dec_params, dec_cfg: decoder_mod.DecoderConfig, join_params, batch: int,
               max_tokens: int = 1024, compute_dtype=None) -> GreedyState:
    dev = dec_params["embedding"]["table"].device
    hyp = torch.full((batch, dec_cfg.context_size), dec_cfg.blank_id, dtype=torch.int64,
                     device=dev)
    dec_out = decoder_mod.forward(dec_params, dec_cfg, hyp)
    zeros = torch.zeros((batch, max_tokens), dtype=torch.int64, device=dev)
    return GreedyState(
        hyp=hyp,
        dec_proj=joiner_mod.project_decoder(join_params, dec_out, compute_dtype),
        tokens=zeros,
        timestamps=zeros.clone(),
        count=torch.zeros((batch,), dtype=torch.int64, device=dev),
        trailing_blanks=torch.zeros((batch,), dtype=torch.int64, device=dev),
    )


def _emit(st: GreedyState, tables, dec_cfg, join_params, emit, y, frame, compute_dtype):
    """Apply one emission step: lanes with ``emit`` append ``y`` at
    ``frame`` and refresh their decoder output."""
    lane = torch.arange(st.hyp.shape[0], device=st.hyp.device)
    max_tokens = st.tokens.shape[1]
    new_hyp = torch.cat([st.hyp[:, 1:], y[:, None]], dim=1)
    hyp = torch.where(emit[:, None], new_hyp, st.hyp)
    dec_out = decoder_mod.forward_from_tables(tables, dec_cfg, hyp)
    dec_proj_new = joiner_mod.project_decoder(join_params, dec_out, compute_dtype)
    dec_proj = torch.where(emit[:, None], dec_proj_new, st.dec_proj)
    pos = torch.clamp(st.count, max=max_tokens - 1)
    st.tokens[lane, pos] = torch.where(emit, y, st.tokens[lane, pos])
    st.timestamps[lane, pos] = torch.where(emit, frame, st.timestamps[lane, pos])
    return hyp, dec_proj, st.count + emit.long()


def _blankish(y, extra_skip_sos: bool, blank: int):
    out = (y == blank) | (y == _UNK)
    return out | (y == 1) if extra_skip_sos else out


def greedy_frames(dec_params, dec_cfg, join_params, state: GreedyState, enc_proj, enc_lens,
                  frame_offset, extra_skip_sos: bool = False, compute_dtype=None) -> GreedyState:
    """Advance greedy decode over ``T`` encoder frames, one step per frame
    (the oracle).  enc_proj: [B, T, J] joiner-projected encoder frames."""
    t_max = enc_proj.shape[1]
    max_tokens = state.tokens.shape[1]
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = dataclasses.replace(state, tokens=state.tokens.clone(),
                             timestamps=state.timestamps.clone())
    for t in range(t_max):
        logits = joiner_mod.joint_logits(join_params, enc_proj[:, t], st.dec_proj, compute_dtype)
        y = torch.argmax(logits, dim=-1)
        valid = t < enc_lens
        emit = valid & ~_blankish(y, extra_skip_sos, dec_cfg.blank_id) & (st.count < max_tokens)
        hyp, dec_proj, count = _emit(st, tables, dec_cfg, join_params, emit, y,
                                     frame_offset + t, compute_dtype)
        trailing = torch.where(
            valid, torch.where(emit, 0, st.trailing_blanks + 1), st.trailing_blanks
        )
        st = GreedyState(hyp, dec_proj, st.tokens, st.timestamps, count, trailing)
    return st


def greedy_frames_skip_reference(dec_params, dec_cfg, join_params, state: GreedyState,
                                 enc_proj, enc_lens, frame_offset,
                                 extra_skip_sos: bool = False, compute_dtype=None,
                                 window: int = 64) -> GreedyState:
    """The plain version of ``greedy_frames_skip``: blank-skipping greedy
    decode, identical results to ``greedy_frames`` in
    max-over-lanes(#tokens + ceil(T/window)) trips instead of T, as a Python
    loop with one host sync per trip (the loop condition).

    Per trip: each lane's window starts at ``clip(t_ptr, 0, T - w)``; the
    first non-blank argmax at or after ``t_ptr`` (and before ``enc_lens``)
    is the candidate; a lane with none consumes its window as blanks, and a
    candidate blocked by a full token buffer counts as a blank too."""
    b, t_max, _ = enc_proj.shape
    dev = enc_proj.device
    max_tokens = state.tokens.shape[1]
    lane = torch.arange(b, device=dev)
    w = min(t_max, window)
    ar = torch.arange(w, device=dev)
    enc_lens = enc_lens.to(dev, torch.int64)
    tables = decoder_mod.context_tables(dec_params, dec_cfg)
    st = dataclasses.replace(state, tokens=state.tokens.clone(),
                             timestamps=state.timestamps.clone())
    t_ptr = torch.zeros((b,), dtype=torch.int64, device=dev)
    while bool(torch.any(t_ptr < enc_lens)):  # the one host sync per trip
        start = torch.clamp(t_ptr, 0, t_max - w)  # [B] window start per lane
        abs_t = start[:, None] + ar[None, :]  # [B, W]
        win = enc_proj[lane[:, None], abs_t]  # [B, W, J]
        logits = joiner_mod.joint_logits(join_params, win, st.dec_proj[:, None, :],
                                         compute_dtype)  # [B, W, V]
        y = torch.argmax(logits, dim=-1)  # [B, W]
        active = t_ptr < enc_lens
        cand = (~_blankish(y, extra_skip_sos, dec_cfg.blank_id)
                & (abs_t >= t_ptr[:, None]) & (abs_t < enc_lens[:, None]))
        has = torch.any(cand, dim=1)
        # first candidate's offset in the window; 0 when the lane has none
        first_rel = torch.where(has, torch.where(cand, ar, w).amin(dim=1), 0)
        first = start + first_rel
        emit = has & active & (st.count < max_tokens)
        hyp, dec_proj, count = _emit(st, tables, dec_cfg, join_params, emit,
                                     y[lane, first_rel], frame_offset + first, compute_dtype)
        # frames scanned this trip end at the window edge (or the lane's
        # length); every frame consumed without an emission was a blank
        scanned_to = torch.minimum(start + w, enc_lens)
        t_new = torch.where(active, torch.where(emit, first + 1, scanned_to), t_ptr)
        trailing = torch.where(
            active,
            torch.where(emit, 0, st.trailing_blanks + (scanned_to - t_ptr)),
            st.trailing_blanks,
        )
        st = GreedyState(hyp, dec_proj, st.tokens, st.timestamps, count, trailing)
        t_ptr = t_new
    return st


def greedy_frames_skip(dec_params, dec_cfg, join_params, state: GreedyState, enc_proj,
                       enc_lens, frame_offset, extra_skip_sos: bool = False,
                       compute_dtype=None, window: int = 64,
                       operands: "GreedyOperands | None" = None) -> GreedyState:
    """Blank-skipping greedy decode over ``T`` encoder frames — identical
    results to ``greedy_frames``.  enc_proj: [B, T, J] joiner-projected
    encoder frames.

    CPU tensors run the plain version (``greedy_frames_skip_reference``,
    ``window`` frames per trip).  CUDA tensors launch the kernel once, with
    no host sync, or raise ``ValueError`` for what it does not take; there is
    no fallback.  ``window`` does not change the result and the kernel does
    not read it.  ``operands``: ``greedy_operands(dec_params, dec_cfg,
    join_params, compute_dtype)``, built here when not given.
    ``greedy_frames_skip.launches`` counts the kernel's launches: one per
    call, a grid of B clusters of ``CLUSTER`` blocks; a CUDA graph's replay
    adds the launches its capture recorded (``runtime/program.py``)."""
    if enc_proj.device.type == "cpu":
        return greedy_frames_skip_reference(dec_params, dec_cfg, join_params, state, enc_proj,
                                            enc_lens, frame_offset, extra_skip_sos,
                                            compute_dtype, window)
    if enc_proj.device.type != "cuda":
        raise ValueError(f"greedy_frames_skip: unsupported device {enc_proj.device}")
    if operands is None:
        operands = greedy_operands(dec_params, dec_cfg, join_params, compute_dtype)
    return _launch_kernel(operands, dec_cfg, state, enc_proj, enc_lens, frame_offset,
                          extra_skip_sos, compute_dtype)


greedy_frames_skip.launches = 0


@dataclasses.dataclass(frozen=True)
class GreedyOperands:
    """The kernel's operands (``greedy_operands``), on the decoder's device.
    Jp and Vp are J and V rounded up to 16 and 8 (zero padding); both
    weights are unit-major (an n-tile of W_out, a chunk of decoder_proj.w:
    8 columns each), so each block's share is a contiguous range."""

    tables: torch.Tensor  # [C, V, D] float32 — the folded context tables
    dec_w: torch.Tensor  # [Jp/8, D, 8] — decoder_proj.w in the compute dtype, by chunk
    dec_b: torch.Tensor  # [Jp] float32 — decoder_proj.b
    out_w: torch.Tensor  # bf16: [Vp/8, Jp/16, 32, 4] mma fragments; f32: [Vp/8, Jp, 8]
    out_b: torch.Tensor  # [Vp] float32 — output.b
    vocab: int
    joiner_dim: int
    compute_dtype: torch.dtype | None


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _bias(p, n: int, like: torch.Tensor) -> torch.Tensor:
    return p["b"].float() if "b" in p else torch.zeros((n,), device=like.device)


def greedy_operands(dec_params, dec_cfg, join_params, compute_dtype=None) -> GreedyOperands:
    """The kernel's operands from the decoder and the joiner, built with
    device ops only (no host sync): the folded context tables
    (``decoder.context_tables``), ``decoder_proj`` with its weight in the
    compute dtype (``apply_linear`` casts it the same way) in 8-column
    chunks (``pack_chunks``), and ``output``, whose weight under bf16 is
    packed into the B fragments of ``mma.sync.m16n8k16`` (``pack_mma_b``)
    and under float32 into 8-column n-tiles (``pack_chunks``)."""
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"greedy kernel: compute_dtype must be None or bfloat16, "
                         f"got {compute_dtype}")
    tables = torch.stack([t.float() for t in decoder_mod.context_tables(dec_params, dec_cfg)])
    dp, out = join_params["decoder_proj"], join_params["output"]
    w_dp, w_out = dp["w"], out["w"]
    d, j = w_dp.shape
    v = w_out.shape[1]
    if w_out.shape[0] != j or tables.shape[1:] != (v, d):
        raise ValueError(f"greedy kernel: decoder tables {tuple(tables.shape)}, decoder_proj "
                         f"{tuple(w_dp.shape)} and output {tuple(w_out.shape)} do not chain")
    jp, vp = _round_up(j, 16), _round_up(v, 8)
    wdt = torch.float32 if compute_dtype is None else compute_dtype
    w_pad = F.pad(w_out.float(), (0, vp - v, 0, jp - j))
    return GreedyOperands(
        tables=tables.contiguous(),
        dec_w=pack_chunks(F.pad(w_dp.to(wdt), (0, jp - j))),
        dec_b=F.pad(_bias(dp, j, w_dp), (0, jp - j)).contiguous(),
        out_w=pack_chunks(w_pad) if compute_dtype is None else pack_mma_b(w_pad.to(wdt)),
        out_b=F.pad(_bias(out, v, w_out), (0, vp - v)).contiguous(),
        vocab=v, joiner_dim=j, compute_dtype=compute_dtype,
    )


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """w [Kp, Np] (Kp % 16 == 0, Np % 8 == 0) -> [Np/8, Kp/16, 32, 4]: for
    each 8-column tile and 16-deep k-step, each lane's four values of the B
    operand of ``mma.sync.m16n8k16.row.col`` in register order — lane
    4g + q holds w[k0 + 2q + {0, 1, 8, 9}, n0 + g] — so a warp loads one
    fragment as 256 contiguous bytes."""
    kp, np_ = w.shape
    x = w.reshape(kp // 16, 2, 4, 2, np_ // 8, 8)  # k = 16ks + 8h + 2q + e, n = 8nt + g
    return x.permute(4, 0, 5, 2, 1, 3).contiguous().reshape(np_ // 8, kp // 16, 32, 4)


def pack_chunks(w: torch.Tensor) -> torch.Tensor:
    """w [K, Np] (Np % 8 == 0) -> [Np/8, K, 8]: each 8-column chunk's K rows
    contiguous, the float32 n-tiles of W_out and the chunks of
    decoder_proj.w."""
    k, np_ = w.shape
    return w.reshape(k, np_ // 8, 8).permute(1, 0, 2).contiguous()


def rank_ranges(units: int) -> list[tuple[int, int]]:
    """Each block's share [lo, hi) of ``units`` 8-column units, in rank
    order: contiguous, each unit owned once, the first ``units % CLUSTER``
    ranks one unit more than the rest (the kernel's ``share_lo``)."""
    base, extra = divmod(units, CLUSTER)
    lo = [r * base + min(r, extra) for r in range(CLUSTER + 1)]
    return [(lo[r], lo[r + 1]) for r in range(CLUSTER)]


def kernel_plan(joiner_dim: int, decoder_dim: int, vocab: int, compute_dtype=None,
                context: int = 2) -> dict:
    """What the kernel would use on the current card at these shapes (its C
    entry ``k2t_rnnt_greedy_plan``): shared memory per block, the resident
    and streamed units per block, ``cudaOccupancyMaxActiveClusters``, its
    registers and local (spill) bytes per thread and the stages of its
    weight rings (``PLAN_KEYS``).  Needs the card."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    fn = cuda_build.function("rnnt_greedy", "k2t_rnnt_greedy_plan", _PLAN_ARGTYPES)
    err = fn(joiner_dim, decoder_dim, vocab, context, _DTYPE_CODE[compute_dtype],
             ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"rnnt_greedy plan failed: cudaError {err}")
    return dict(zip(PLAN_KEYS, list(out)))


def _launch_kernel(ops: GreedyOperands, dec_cfg, state: GreedyState, enc_proj, enc_lens,
                   frame_offset, extra_skip_sos, compute_dtype) -> GreedyState:
    b, t_max, j = enc_proj.shape
    dev = enc_proj.device
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    c, v, d = ops.tables.shape
    k = state.tokens.shape[1]
    if ops.compute_dtype != compute_dtype:
        raise ValueError(f"greedy kernel: operands built for {ops.compute_dtype}, "
                         f"called with {compute_dtype}")
    if enc_proj.dtype != dtype or state.dec_proj.dtype != dtype:
        raise ValueError(f"greedy kernel: enc_proj {enc_proj.dtype} and dec_proj "
                         f"{state.dec_proj.dtype} must be {dtype}")
    if j != ops.joiner_dim or tuple(state.dec_proj.shape) != (b, j):
        raise ValueError(f"greedy kernel: enc_proj {tuple(enc_proj.shape)}, dec_proj "
                         f"{tuple(state.dec_proj.shape)}, operands J={ops.joiner_dim}")
    if tuple(state.hyp.shape) != (b, c) or state.tokens.shape[0] != b or k < 1:
        raise ValueError(f"greedy kernel: hyp {tuple(state.hyp.shape)}, tokens "
                         f"{tuple(state.tokens.shape)} for B={b}, context {c}")
    tensors = (enc_proj, ops.tables, ops.dec_w, ops.dec_b, ops.out_w, ops.out_b, state.hyp,
               state.dec_proj, state.tokens, state.timestamps, state.count,
               state.trailing_blanks)
    if any(x.device != dev for x in tensors):
        raise ValueError("greedy kernel: operands and state must be on enc_proj's device")
    if any(not w.is_contiguous() or w.data_ptr() % 16 for w in (ops.out_w, ops.dec_w)):
        raise ValueError("greedy kernel: out_w and dec_w must be contiguous and 16-byte aligned "
                         "(the blocks copy their shares in bulk)")

    def lane_ints(x):
        return torch.as_tensor(x, device=dev).to(torch.int64).expand(b).contiguous()

    enc, lens, offset = enc_proj.contiguous(), lane_ints(enc_lens), lane_ints(frame_offset)
    # the search reads the small state and writes it anew; the new token
    # buffers start as copies of the old and take the emissions in place
    src = [x.to(want).contiguous() for x, want in (
        (state.hyp, torch.int64), (state.dec_proj, dtype), (state.count, torch.int64),
        (state.trailing_blanks, torch.int64))]
    hyp, dec_proj, count, trailing = (torch.empty_like(x) for x in src)
    tokens, timestamps = (x.to(torch.int64).contiguous().clone()
                          for x in (state.tokens, state.timestamps))
    out = GreedyState(hyp, dec_proj, tokens, timestamps, count, trailing)
    if b == 0:
        return out
    fn = cuda_build.function("rnnt_greedy", "k2t_rnnt_greedy", _ARGTYPES)
    cuda_build.launch("rnnt_greedy", fn, dev,
                      enc.data_ptr(), lens.data_ptr(), offset.data_ptr(),
                      ops.tables.data_ptr(), ops.dec_w.data_ptr(), ops.dec_b.data_ptr(),
                      ops.out_w.data_ptr(), ops.out_b.data_ptr(),
                      *(x.data_ptr() for x in src),
                      *(x.data_ptr() for x in (hyp, dec_proj, count, trailing, tokens,
                                               timestamps)),
                      b, t_max, j, d, v, c, k, dec_cfg.blank_id, int(extra_skip_sos),
                      _DTYPE_CODE[compute_dtype])
    greedy_frames_skip.launches += 1
    return out


def rnnt_greedy_search(dec_params, dec_cfg: decoder_mod.DecoderConfig, join_params,
                       join_cfg: joiner_mod.JoinerConfig, enc_out, enc_lens,
                       max_tokens: int = 1024, extra_skip_sos: bool = False,
                       compute_dtype=None):
    """Offline whole-utterance greedy search over enc_out [B, T, encoder_dim]
    (the joiner projection, then ``greedy_frames_skip`` from frame 0):
    returns (tokens, timestamps, count).  ``join_cfg`` is unused, as in the
    reference's signature."""
    b = enc_out.shape[0]
    enc_proj = joiner_mod.project_encoder(join_params, enc_out, compute_dtype)
    state = init_state(dec_params, dec_cfg, join_params, b, max_tokens, compute_dtype)
    zero = torch.zeros((b,), dtype=torch.int64, device=enc_out.device)
    final = greedy_frames_skip(dec_params, dec_cfg, join_params, state, enc_proj, enc_lens, zero,
                               extra_skip_sos, compute_dtype)
    return final.tokens, final.timestamps, final.count


def extract_results(tokens, timestamps, count) -> list[tuple[list[int], list[int]]]:
    """Token buffers -> per-lane Python lists (one device-to-host copy each)."""
    tokens, timestamps, count = tokens.cpu(), timestamps.cpu(), count.cpu()
    out = []
    for b in range(tokens.shape[0]):
        n = int(count[b])
        out.append((tokens[b, :n].tolist(), timestamps[b, :n].tolist()))
    return out

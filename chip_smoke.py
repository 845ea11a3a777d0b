#!/usr/bin/env python3
"""Drive the PyTorch port (k2transducerasr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):
  1. the card's name and power limit (nvidia-smi), TF32 flags set off;
  2. build the CUDA kernels from csrc/ with nvcc and load them;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the flagship main path gives it, with its time, the plain
     version's time and the bound;
  4. the committed zipformer2 pin model dir, float32 on the card, must give
     the pinned transcript and timestamps exactly;
  5. the full-width Zipformer2Config() from a seed, one 5 s utterance in
     float32: card (kernel) against CPU (plain) — encoder output within
     tolerance, tokens identical;
  6. the main path at full width: bf16, batches of 16 x 30 s through
     begin_decode/end_decode, kernel launches counted.
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Needs one card; exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config
from k2transducerasr_tpu_torch.ops import attention_cuda as AC

REPO = os.path.dirname(os.path.abspath(__file__))
PIN_DIR = os.path.join(REPO, "tests", "torch_port_data", "zipformer2_pin")
PIN_TEXT = "tok25tok25tok18tok8tok12tok6tok25tok6"
PIN_TIMESTAMPS = [0, 1, 2, 3, 4, 5, 6, 7]

# flagship (Zipformer2Config()) at 16 x 30 s: t_pad 3072 frames -> 1532
# encoder-rate frames; (T, heads, layers) per stack at downsampling 1,2,4,8,4,2
FLAGSHIP_B = 16
FLAGSHIP_STACKS = [(1532, 4, 2), (766, 4, 2), (383, 4, 3), (192, 8, 4), (383, 4, 3),
                   (766, 4, 2)]
QD, PD = 32, 4

F32_ATOL = 1e-5  # kernel vs plain, float32 probs: summation order only
BF16_ULPS = 1    # kernel vs plain, bf16 probs: both round one f32 value


def log(*a):
    print(*a, flush=True)


def card_bandwidth(name: str) -> float:
    """Device-memory bandwidth (bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12  # H100 SXM


def peak_flops(dtype) -> float:
    """Dense peak of the unit the work's type runs on (H100 SXM data sheet)."""
    return 989e12 if dtype == torch.bfloat16 else 67e12


def synth_pcm(n, seed):
    """Speech-band test signal (bench.py's synth_pcm formula)."""
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 180.0 + 40.0 * (seed % 7)
    return (
        0.22 * np.sin(2 * np.pi * (f0 + 15.0 * np.sin(2 * np.pi * 0.31 * t)) * t)
        + 0.18 * np.sin(2 * np.pi * (2.37 * f0) * t + 1.0 + 0.8 * np.sin(2 * np.pi * 0.47 * t))
        + 0.12 * rng.standard_normal(n)
    ).astype(np.float32)


def pin_pcm(n, seed=9):
    """tests/test_pinned_transcripts.py's _pcm."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 420 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def streams_for(rec, pcms):
    out = []
    for x in pcms:
        s = rec.create_offline_stream()
        s.add_samples(x)
        out.append(s)
    return out


# ---------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    t0 = time.time()
    path = AC.build(verbose=True)
    AC._load()
    secs = time.time() - t0
    log(f"[2] built and loaded {os.path.relpath(path, REPO)} in {secs:.1f} s")
    return secs


def _k1_inputs(b, t, s, h, dtype, seed, ragged=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((b, t, h, QD), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, h, QD), generator=g, device=dev).to(dtype)
    pq = torch.randn((b, t, h, PD), generator=g, device=dev).to(dtype)
    pk = torch.randn((t + s - 1, h, PD), generator=g, device=dev).to(dtype)
    if ragged:
        lens = torch.tensor([s - (i * s) // (2 * b) for i in range(b)], device=dev,
                            dtype=torch.int32)
        lens[-1] = 1  # a lane with one valid key
    else:
        lens = None
    return q, k, pq, pk, lens


def _k1_bytes_ops(b, t, s, h, in_dtype, out_dtype):
    ie = torch.finfo(in_dtype).bits // 8
    oe = torch.finfo(out_dtype).bits // 8
    nbytes = (2 * b * t * h * QD + b * t * h * PD + (t + s - 1) * h * PD) * ie \
        + 2 * 4 * b + b * h * t * s * oe
    ops = 2 * b * h * t * s * (QD + PD)
    return nbytes, ops


def _max_err(out, ref, dtype):
    """(max abs error, ok) against the stated tolerance."""
    d = (out.float() - ref.float()).abs()
    err = float(d.max())
    if dtype == torch.float32:
        return err, err <= F32_ATOL
    # one bf16 ulp of the plain value: 2^(floor(log2|ref|) - 7)
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return err, bool((d <= BF16_ULPS * ulp).all())


def phase_k1(bw):
    rows = []
    worst = 0.0
    cases = []
    for si, (t, h, layers) in enumerate(FLAGSHIP_STACKS):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"stack{si}", FLAGSHIP_B, t, t, h, dtype, {}, layers))
    t0 = FLAGSHIP_STACKS[0][0]
    cases.append(("stack0-chunk32-left128", FLAGSHIP_B, t0, t0, 4, torch.bfloat16,
                  {"chunk": 32, "left": 128}, 0))
    cases.append(("stack0-chunk32-left128", FLAGSHIP_B, t0, t0, 4, torch.float32,
                  {"chunk": 32, "left": 128}, 0))
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("kv_start-T32-S160", FLAGSHIP_B, 32, 160, 4, dtype, {"kv_start": True}, 0))

    for name, b, t, s, h, dtype, kw, layers in cases:
        q, k, pq, pk, lens = _k1_inputs(b, t, s, h, dtype, seed=len(rows))
        kw = dict(kw)
        if kw.pop("kv_start", False):
            kw["kv_start"] = torch.randint(0, s - t, (b,), device="cuda", dtype=torch.int32)
            kw["kv_start"][0] = 0
        out = AC.relpos_attn_probs(q, k, pq, pk, lens, **kw)
        ref = AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw)
        torch.cuda.synchronize()
        err, ok = _max_err(out, ref, dtype)
        if not ok:
            raise AssertionError(f"K1 {name} {dtype}: kernel disagrees with plain (max {err})")
        worst = max(worst, err)
        ms = cuda_ms(lambda: AC.relpos_attn_probs(q, k, pq, pk, lens, **kw), reps=20)
        plain_ms = cuda_ms(lambda: AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw),
                           reps=5, warm=1)
        nbytes, ops = _k1_bytes_ops(b, t, s, h, dtype, dtype)
        t_bytes, t_ops = nbytes / bw * 1e3, ops / peak_flops(dtype) * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({"case": name, "dtype": str(dtype).split(".")[-1], "B": b, "T": t, "S": s,
                     "H": h, "layers": layers, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        log(f"[3] K1 {name:24s} {rows[-1]['dtype']:8s} B={b} T={t} S={s} H={h}: "
            f"max_err {err:.3e} ok | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"bound {bound:.4f} ms ({rows[-1]['bound_by']})")
        del q, k, pq, pk, lens, out, ref
        torch.cuda.empty_cache()
    return rows, worst


def phase_golden():
    bundle = ModelBundle.from_dir(PIN_DIR, device="cuda")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
    AC.relpos_attn_probs.launches = 0
    res = rec.get_result(streams_for(rec, [pin_pcm(6400)])[0])
    launches = AC.relpos_attn_probs.launches
    log(f"[4] pin on card: {res.text!r} {res.timestamps} (K1 launches {launches})")
    if res.text != PIN_TEXT or res.timestamps != PIN_TIMESTAMPS:
        raise AssertionError(f"pin mismatch: {res.text!r} {res.timestamps}")
    if launches == 0:
        raise AssertionError("pin decode did not launch K1")


def phase_full_width_vs_cpu():
    cfg = Zipformer2Config()
    pcm = [synth_pcm(5 * 16000, 101)]
    outs = {}
    for dev in ("cuda", "cpu"):
        bundle = ModelBundle.random("zipformer2", cfg, vocab_size=500, seed=0, device=dev)
        rec = OfflineRecognizer(bundle, compute_dtype=None, device=dev)
        t0 = time.time()
        samples, counts = rec.pcm_batch(streams_for(rec, pcm))
        enc, lens = rec.encode(samples, counts)
        res = rec.get_results(streams_for(rec, pcm))[0]
        outs[dev] = (enc.float().cpu(), lens.cpu(), res)
        log(f"[5] full width f32 on {dev}: enc {tuple(enc.shape)}, "
            f"{len(res.tokens)} tokens, {time.time() - t0:.1f} s")
    (eg, lg, rg), (ec, lc, rc) = outs["cuda"], outs["cpu"]
    if not torch.equal(lg, lc):
        raise AssertionError(f"enc lens differ: {lg} vs {lc}")
    diff = float((eg - ec).abs().max())
    scale = float(ec.abs().max())
    log(f"[5] encoder card vs CPU: max abs diff {diff:.3e} (max |enc| {scale:.3f}); "
        f"tokens identical: {rg.tokens == rc.tokens}")
    if not torch.allclose(eg, ec, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"encoder output card vs CPU beyond rtol/atol 1e-3 ({diff})")
    if rg.tokens != rc.tokens or rg.timestamps != rc.timestamps:
        raise AssertionError("tokens differ between card and CPU")


def phase_main_path(n_batches=2):
    cfg = Zipformer2Config()
    bundle = ModelBundle.random("zipformer2", cfg, vocab_size=500, seed=0, device="cuda")
    rec = OfflineRecognizer(bundle, device="cuda")  # bf16 compute
    n = 30 * 16000
    batches = [streams_for(rec, [synth_pcm(n, k * FLAGSHIP_B + i) for i in range(FLAGSHIP_B)])
               for k in range(n_batches + 1)]
    rec.get_results(batches[0])  # warm-up (cuBLAS/cuDNN handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    AC.relpos_attn_probs.launches = 0
    t0 = time.time()
    results = []
    for k in range(1, n_batches + 1):
        results.extend(rec.end_decode(rec.begin_decode(batches[k])))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = AC.relpos_attn_probs.launches

    per_batch = sum(cfg.num_encoder_layers)
    if launches != per_batch * n_batches:
        raise AssertionError(f"K1 launched {launches} times, expected {per_batch * n_batches}")
    ms_batch = wall / n_batches * 1e3
    audio_rate = n_batches * FLAGSHIP_B * 30.0 / wall
    peak = torch.cuda.max_memory_allocated() / 2**30
    toks = [len(r.tokens) for r in results]

    # one more batch split into stages (not part of the counted run)
    samples, counts = rec.pcm_batch(batches[1])
    torch.cuda.synchronize()
    t1 = time.time()
    enc, lens = rec.encode(samples, counts)
    torch.cuda.synchronize()
    t2 = time.time()
    if not bool(torch.isfinite(enc).all()) or enc.shape[0] != FLAGSHIP_B:
        raise AssertionError("encoder output not finite or wrong batch")
    rec.end_decode(rec.begin_decode(batches[1]))
    torch.cuda.synchronize()
    t3 = time.time()
    enc_ms, full_ms = (t2 - t1) * 1e3, (t3 - t2) * 1e3
    if min(toks) == 0 or max(toks) > rec.max_tokens:
        raise AssertionError(f"implausible token counts {min(toks)}..{max(toks)}")
    log(f"[6] main path bf16, {n_batches} batches x {FLAGSHIP_B} x 30 s: {ms_batch:.1f} ms/batch, "
        f"{audio_rate:.1f} audio-s/s, peak {peak:.2f} GiB, K1 launches {launches} "
        f"({per_batch}/batch), tokens/utt {statistics.mean(toks):.1f} "
        f"(min {min(toks)} max {max(toks)}), enc out {tuple(enc.shape)}")
    log(f"[6] stage split (host clock, one batch): fbank+encoder {enc_ms:.1f} ms; "
        f"whole decode {full_ms:.1f} ms -> joiner+greedy ~{full_ms - enc_ms:.1f} ms")
    return launches, ms_batch, audio_rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card",
              file=sys.stderr)
        return 2
    t_start = time.time()
    phase_card()
    bw = card_bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    rows, worst = phase_k1(bw)
    phase_golden()
    phase_full_width_vs_cpu()
    launches, _, _ = phase_main_path()

    # K1 per flagship batch: its 16 calls at the bf16 main-path shapes
    main_rows = [r for r in rows if r["dtype"] == "bfloat16" and r["layers"]]
    per_batch = {key: sum(r[key] * r["layers"] for r in main_rows)
                 for key in ("ms", "plain_ms", "bound_ms")}
    kernels = [{
        "name": "relpos_attn_probs",
        "route": "cuda",
        "source": "k2transducerasr_tpu_torch/csrc/relpos_attn_probs.cu",
        "replaces": "k2transducerasr_tpu/ops/attention_pallas.py:158",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_batch["ms"],
        "plain_ms": per_batch["plain_ms"],
        "bound_ms": per_batch["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in main_rows)
                     else "operations"),
        "library_ms": None,
        "per": "one flagship batch (16 x 30 s): 16 calls at the bf16 stack shapes",
    }]
    log(f"[7] total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

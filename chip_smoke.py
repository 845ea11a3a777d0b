#!/usr/bin/env python3
"""Drive the PyTorch port (k2transducerasr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):
  1. the card's name and power limit (nvidia-smi), TF32 flags set off;
  2. build the CUDA kernels from csrc/ with nvcc (one process per source,
     started together);
  3. K1 (relpos_attn_probs) against its plain PyTorch version on the card,
     at the shapes the zipformer2 and zipformer v1 main paths give it (the
     offline stacks, and the streaming stacks, T != S with kv_start per
     lane; v1's q head is 24 wide; and q and pos heads of 128, the chunked
     bodies), with its time, the plain version's time and the bound.  A
     kernel's ``ms`` is CUDA events around one call from
     an empty queue (the host's time to prepare and
     launch it included); ``device_ms`` beside it is the device time per
     call with the queue kept full (CUDA events around calls queued behind
     a spin kernel), and ``host_us`` the wrapper's host time per call;
  3b. K2 (relpos_attn_ctx) the same at the conformer's shapes (offline and
     streaming; and 4 heads of 128, the chunked bodies), plus the time of
     scaled_dot_product_attention on the same function (yardstick);
  3c. the greedy search kernel (rnnt_greedy: one cluster of 8 blocks per
     lane, the joiner's weights in the cluster's shared memory where they
     fit) against its plain version at the main paths' shapes (offline: 16
     lanes x 766 frames; streaming: 16 lanes x one window's frames,
     frame_offset per lane, extra_skip_sos, steps chained), float32
     identical (dec_proj within 1e-5), bf16 through the tie-aware replay at
     2 ulps with the frames decided otherwise than the plain argmax counted,
     and on dyadic inputs (every float32 sum exact, ties everywhere) bit for
     bit in both dtypes; offline bf16 also with the blank bias raised until
     about one frame in six emits, and at a vocabulary of 5,500 (the weights
     streamed), and at J = D = 1536 with 10 tokens of context (past the
     caps the kernel once had); first a line with the cluster, each case's
     shared memory and residency, cudaOccupancyMaxActiveClusters and
     -Xptxas -v's registers and spills; its time, the plain loop's and the
     bound from these inputs' frames and emissions, and the replaced
     one-block-per-lane kernel's times from PERF.md beside them;
  3d. the beam search kernel (rnnt_beam: P lanes on a cluster of 8 blocks,
     K beams, the trips of the plain version, one exchange per frame) against
     its plain version: offline 16 lanes x 766 frames at K=4 in float32
     (every state field and each frame's recorded choice equal; scores to
     atol 1e-4 + rtol 1e-5) and bf16 (the beam replay at 2 ulps), 15 lanes,
     a streaming step of 16 lanes (steps chained, frame_offset,
     extra_skip_sos), one frame in six emitting, K=8, a vocabulary of 5,500
     (the weights streamed), ragged lanes that the kernel pairs by length, and in
     float32 a vocabulary of 5 where the forbidden columns enter the top K;
     each case's P, clusters, clusters at once and waves (16 lanes at K=4
     must take one), microseconds per frame of a cluster and the emission
     steps that took the second exchange; the plans, held equal to the host
     mirror, with registers and spills; each case's time, its device time,
     the plain loop's (once: it syncs once per trip) and the bound from these
     inputs' frames and emitting beams, the replaced kernel's times beside;
  3e. bias_swoosh (the zipformer2 encoder's bias + Swoosh) against its plain
     version at every shape of the benchmark's longform batch (20 x 30 s)
     and offpeak step (820 lanes), each bf16 out to one bf16 ulp, with its
     time, its device time, the plain version's time and the bound (its
     bytes over the bandwidth); every zipformer2 path below counts its 84
     launches per flagship batch and step;
  3f. the encoders' convolutions (all but the depthwise ones) at the
     benchmark cells' shapes and layouts, recorded from one eager conformer
     and zipformer2 longform batch (20 x 30 s) and offpeak step (820
     lanes): each one's device time with cuDNN's TF32 allowed
     (ops/layers.conv_tf32) and on FFMA, beside its bounds; those the port
     scopes held to FFMA within the float32 summation-order bound; every
     path below counts its conv_tf32 calls per batch and step (FAMILIES'
     ``convs``: 26 conformer, 2 each zipformer);
  4. each committed pin model dir (zipformer2, conformer, zipformer2-CTC,
     zipformer v1, LSTM), float32 on the card, must give its pinned
     transcript and timestamps exactly, offline and through
     OnlineRecognizer.decode_to_end (the online
     pin); under modified_beam_search (K=4) the zipformer2 and conformer pin
     dirs must give every n-best hypothesis of BEAM_PINS, offline and online;
  4b. a conformer with 4 heads of 128 (ConformerConfig(num_heads=4), full
     width from a seed, f32, 5 s): card against CPU, the encoder output
     within tolerance and the tokens identical;
  5. each family at full width from a seed, one 5 s utterance in float32:
     card (kernel) against CPU (plain) — offline encoder output and each
     streaming step's encoder output within tolerance, tokens and
     timestamps identical; and zipformer2 under modified_beam_search: the
     best beam's tokens and timestamps identical, its score within 1e-3;
  6. each offline main path at full width: bf16, batches of 16 x 30 s
     through begin_decode/end_decode, each batch one replay of the
     recognizer's CUDA graph (runtime/program.py), every kernel's launches
     counted from 0 through the replay's arithmetic (greedy search for each
     family, zipformer2-CTC, and zipformer2 under modified_beam_search; LSTM
     launches neither attention kernel; every greedy path one rnnt_greedy
     per batch, the beam path one rnnt_beam); a second capture of the same
     key dumped and its kernel nodes counted by name against one batch's
     launches; the first batch's host ms (warm-up run, capture, replay), the
     graph pool's bytes, one replay's device time and the device busy share
     over 3 batches, the kernels in that profiler trace counted by name
     against the counters; each timed batch
     held bit for bit against eager _decode of the same batch; one greedy
     batch's search held to the tie-aware replay, each beam batch's eager
     search to the beam replay;
  6b. each streaming main path at full width (each family's causal config):
     bf16, 16 lanes x 30 s through OnlineRecognizer.begin_step/end_step,
     one window per step, each step one replay of the recognizer's CUDA
     graph over the whole lane pool; per-step latency (p50, p95), streaming
     RTF, begin_step's host ms and the launches per step (the same methods
     as phase 6); the first step's ms (warm-up on the idle pool, capture,
     replay), a second capture of the key dumped and its kernel nodes
     counted against one step's launches, the graph pool's and the lane
     pool's bytes, one replay's device time with 16 and with 2 lanes ready,
     a step with 2 of 16 streams ready beside all 16, the device busy share
     and the kernels the profiler traced; the step split (fbank, encoder,
     freeze + search); the graph against the eager step function on a
     second recognizer, bit for bit on every pool leaf and the tokens after
     every step, half the lanes idle in every other step (idle lanes
     untouched), each beam step held to the beam replay; zipformer2 greedy
     also at windows_per_step=2, its tokens those of one window a step;
  6c. no wait: zipformer2 at full width, 16 x 30 s, bf16: begin_decode
     under torch.cuda.set_sync_debug_mode("error") (greedy and CTC,
     reference_pad_compat off and on; modified_beam_search with and without
     hotwords) and begin_step (the same methods, 16 lanes, each step a
     graph replay) raise nothing and give the sequential run's tokens, the
     eager route's host ms beside (for begin_step: the same step run
     eagerly, its results equal);
     then the 2-deep pipeline of bench.py over 7 batches against the same
     batches one by one (audio-s/s each, begin_decode's host ms beside the
     batch ms), through the graph and through eager _decode in turns;
  6d. graph memory: zipformer2 greedy at full width, bf16, 16 rows: eager
     _decode's peak allocated and reserved from an emptied cache, then the
     graphs of three buckets (30, 20, 10 s) captured in turn, the pool's
     reserved and allocated bytes and the memory outside it after each; a
     dropped recognizer must leave none of its pool after empty_cache;
  8. int8 (accuracy="int8"): zipformer2 and conformer at full width, f32,
     card against CPU (the int8 weights bit for bit, the encoder within int8's
     own change from float32, tokens identical); their offline main paths
     (bf16, 16 x 30 s, 2 batches, launches counted) and zipformer2's streaming
     main path (16 lanes, as 6b) under int8; torch._int_mm against a bf16 matmul at
     the flagship's largest linear shapes;
  9. ingest: a 5 s 44.1 kHz stereo wav through the native read_wav and
     resampling against the numpy route (the same tokens from the
     zipformer2 pin dir on the card), whisper features card vs CPU, dither's
     noise on the card;
 10. convert: a full-width zipformer2 bundle exported as a synthetic ONNX
     dir, converted, loaded on the card: the source bundle's tokens;
 11. the CLI and the demos in this process (so the launches count): the
     zipformer2 pin dir with the pin signal as a wav, offline (-batch multi)
     and online, must print the pinned transcripts, each offline decode and
     each streaming step through its graph and equal to the eager run bit
     for bit; ``convert``
     on [10]'s ONNX dir must exit 0;
 12. data and tensor parallelism on the one card: two ranks of this script
     (``--parallel-rank``) in a gloo group passing CUDA tensors (NCCL
     refuses two ranks on one device); TP on mesh 1x2 (zipformer2 and
     conformer at full width, f32, 2 x 5 s) and DP on mesh 2x1 (zipformer2
     offline, and streaming with 4 lanes) against one process: tokens and
     timestamps identical, the TP encoder output within PAR_ATOL; per rank
     the launches, peak memory and parameter bytes held.  With two cards or
     more, the same over NCCL.
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Needs one card; exits non-zero without CUDA.

    python3 chip_smoke.py --mutation-check

instead applies each entry of MUTATIONS to a throwaway copy of the package
in a temporary directory and runs the kernel phase it names there; each
must fail (exit 0 when every mutation was caught).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from k2transducerasr_tpu_torch import ModelBundle, OfflineRecognizer, OnlineRecognizer
from k2transducerasr_tpu_torch.decode import rnnt_beam, rnnt_greedy
from k2transducerasr_tpu_torch.frontend.fbank import fbank_compute
from k2transducerasr_tpu_torch.models.conformer import ConformerConfig
from k2transducerasr_tpu_torch.models import decoder as decoder_mod
from k2transducerasr_tpu_torch.models import joiner as joiner_mod
from k2transducerasr_tpu_torch.models.decoder import DecoderConfig
from k2transducerasr_tpu_torch.models.lstm import LstmConfig
from k2transducerasr_tpu_torch.models.registry import get_encoder
from k2transducerasr_tpu_torch.models.zipformer import ZipformerConfig
from k2transducerasr_tpu_torch.models.zipformer2 import Zipformer2Config
from k2transducerasr_tpu_torch.ops import activations_cuda as ACT
from k2transducerasr_tpu_torch.ops import attention_cuda as AC
from k2transducerasr_tpu_torch.ops import cuda_build
from k2transducerasr_tpu_torch.ops import layers as L
from k2transducerasr_tpu_torch.runtime.checkpoint import params_from_numpy, tree_map
from k2transducerasr_tpu_torch.runtime.device import exact_f32
from k2transducerasr_tpu_torch.runtime.offline import PendingDecode
from k2transducerasr_tpu_torch.runtime.program import CudaGraphs, DecodeProgram
from k2transducerasr_tpu_torch.testing import beam_replay, tie_aware_replay
from k2transducerasr_tpu_torch.utils import profiling
from k2transducerasr_tpu_torch.utils.profiling import STEP_STAGES

REPO = os.path.dirname(os.path.abspath(__file__))
PIN_ROOT = os.path.join(REPO, "tests", "torch_port_data")



def swoosh_calls(cfg) -> int:
    """bias_swoosh launches of one zipformer2 forward or streaming step:
    three feed-forwards and two conv modules a layer, the three embed convs
    and the ConvNeXt (84 at the flagship's 16 layers)."""
    return 5 * sum(cfg.num_encoder_layers) + 4


# family -> its config and causal (streaming) config, the kernel its attention
# launches (once per layer: per flagship batch and per streaming step; None:
# the family launches no attention kernel), its pins
# (tests/test_pinned_transcripts.py), whether greedy search runs the
# rnnt_greedy kernel (every transducer: once per batch and per step), and
# the bias_swoosh launches per flagship batch and streaming step (the
# zipformer2 encoder's; 0: the family runs no Swoosh), and the convolutions
# run through ops/layers.conv_tf32 per bf16 batch and step (the embed's of
# 32 output channels or more and the conformer's pointwise ones; no
# depthwise one, and not the zipformers' embed conv1, 1 -> 8 channels)
FAMILIES = {
    "zipformer2": dict(cfg=Zipformer2Config, stream_cfg=lambda: Zipformer2Config(causal=True),
                       kernel="relpos_attn_probs",
                       per_batch=sum(Zipformer2Config().num_encoder_layers),
                       pin_text="tok25tok25tok18tok8tok12tok6tok25tok6",
                       pin_timestamps=[0, 1, 2, 3, 4, 5, 6, 7],
                       online_pin_text="tok25tok25tok18tok8tok12tok6tok25tok6tok12tok6tok25tok6",
                       greedy=True, swoosh=swoosh_calls(Zipformer2Config()), convs=2),
    "conformer": dict(cfg=ConformerConfig, stream_cfg=lambda: ConformerConfig(causal=True),
                      kernel="relpos_attn_ctx",
                      per_batch=ConformerConfig().num_layers,
                      pin_text="tok28tok28tok28tok28", pin_timestamps=[0, 1, 4, 7],
                      online_pin_text="tok28tok28tok28tok28", greedy=True, swoosh=0,
                      convs=2 + 2 * ConformerConfig().num_layers),
    # the zipformer2 encoder under a CTC head (vocab 500 at full width)
    "zipformer2ctc": dict(cfg=Zipformer2Config, stream_cfg=lambda: Zipformer2Config(causal=True),
                          kernel="relpos_attn_probs",
                          per_batch=sum(Zipformer2Config().num_encoder_layers),
                          pin_text="tok29", pin_timestamps=[0], online_pin_text="tok29tok27",
                          greedy=False, swoosh=swoosh_calls(Zipformer2Config()), convs=2),
    # zipformer v1 (icefall pruned_transducer_stateless7): 15 layers, 8 heads
    # of 24, K1 once per layer
    "zipformer": dict(cfg=ZipformerConfig, stream_cfg=lambda: ZipformerConfig(causal=True),
                      kernel="relpos_attn_probs",
                      per_batch=sum(ZipformerConfig().num_encoder_layers),
                      pin_text="tok5tok17tok5tok17tok5tok17tok5tok17",
                      pin_timestamps=[0, 1, 2, 3, 4, 5, 6, 7],
                      online_pin_text="tok5tok17tok5tok17tok5tok17tok5tok17tok5tok23",
                      greedy=True, swoosh=0, convs=2),
    # the LSTM transducer: a cuDNN recurrence, no kernel of this port
    "lstm": dict(cfg=LstmConfig, stream_cfg=LstmConfig, kernel=None, per_batch=0,
                 pin_text="tok6tok15tok15tok15tok15tok15tok15",
                 pin_timestamps=[0, 1, 2, 3, 4, 5, 6, 7],
                 online_pin_text="tok6tok15tok15tok15tok15tok15tok15tok9tok9tok9tok9tok9tok9",
                 greedy=True, swoosh=0, convs=2),
}
BEAM = "modified_beam_search"
BEAM_K = 4
# the families whose int8 paths [8] drives: the flagship and K2's family
INT8_FAMILIES = ("zipformer2", "conformer")
# Every n-best hypothesis (text, timestamps), best first, of the pin dirs
# under modified_beam_search with K=4 at float32 on the pin signal
# (pin_pcm(6400)): offline get_nbest_results, and online get_nbest_results
# after decode_to_end.  Taken from the JAX package's recognizers on the
# CPU; tests/test_torch_beam.py asserts them against it.
_TS8, _TS12, _TS16 = list(range(8)), list(range(12)), list(range(16))
BEAM_PINS = {
    "zipformer2": {
        "offline": [("tok6tok25tok6tok26tok6tok8tok25tok26", _TS8),
                    ("tok6tok25tok6tok26tok6tok8tok25tok6", _TS8),
                    ("tok25tok25tok18tok8tok12tok6tok25tok6", _TS8),
                    ("tok25tok6tok26tok6tok8tok25tok26tok8", _TS8)],
        "online": [("tok25tok6tok26tok6tok8tok25tok26tok8tok12tok6tok25tok6", _TS12),
                   ("tok6tok25tok6tok26tok6tok8tok25tok6tok12tok6tok25tok6", _TS12),
                   ("tok6tok25tok6tok26tok6tok8tok25tok26tok8tok12tok6tok25", _TS12),
                   ("tok25tok6tok26tok6tok8tok25tok26tok8tok12tok12tok6tok25", _TS12)],
    },
    "conformer": {
        "offline": [("tok28tok28tok28tok28tok28tok22tok28tok28", _TS8),
                    ("tok28tok28tok28tok28tok28tok28tok28tok28", _TS8),
                    ("tok28tok28tok22tok28tok28tok28tok28tok28", _TS8),
                    ("tok28tok28tok28tok28tok28tok14tok28tok28", _TS8)],
        "online": [("tok28tok28tok28tok28tok28tok22tok28tok28tok28tok26tok4tok5tok5tok4tok4tok4",
                    _TS16),
                   ("tok28tok28tok28tok28tok28tok22tok28tok28tok28tok26tok4tok5tok5tok4tok4tok5",
                    _TS16),
                   ("tok28tok28tok28tok28tok28tok22tok28tok28tok28tok26tok4tok5tok5tok4tok7tok4",
                    _TS16),
                   ("tok28tok28tok28tok28tok28tok22tok28tok28tok28tok26tok4tok5tok5tok4tok7tok27",
                    _TS16)],
    },
}
KERNELS = {"relpos_attn_probs": AC.relpos_attn_probs, "relpos_attn_ctx": AC.relpos_attn_ctx,
           "rnnt_greedy": rnnt_greedy.greedy_frames_skip,
           "rnnt_beam": rnnt_beam.beam_frames_skip, "bias_swoosh": ACT.bias_swoosh}
GREEDY = "greedy_search"
# the searches' and bias_swoosh's launches on each counted path, filled in
# by the phases
GREEDY_PATHS: dict[str, int] = {}
BEAM_PATHS: dict[str, int] = {}
SWOOSH_PATHS: dict[str, int] = {}
CONV_TF32_PATHS: dict[str, int] = {}
SEARCH_PATHS = {"rnnt_greedy": GREEDY_PATHS, "rnnt_beam": BEAM_PATHS}

# bias_swoosh's shapes ([3e]): the benchmark's longform batch (20 x 30 s,
# 3000 fbank frames) and offpeak step (820 lanes)
SWOOSH_LONGFORM_B, SWOOSH_LONGFORM_FRAMES, SWOOSH_STREAM_LANES = 20, 3000, 820
# flagship (Zipformer2Config()) at 16 x 30 s: t_pad 3072 frames -> 1532
# encoder-rate frames; (T, heads, layers) per stack at downsampling 1,2,4,8,4,2
FLAGSHIP_B = 16
FLAGSHIP_STACKS = [(1532, 4, 2), (766, 4, 2), (383, 4, 3), (192, 8, 4), (383, 4, 3),
                   (766, 4, 2)]
QD, PD = 32, 4
# conformer flagship (ConformerConfig()) at 16 x 30 s: t_pad 3072 frames ->
# ((3072-1)//2 - 1)//2 = 767 frames after the subsampling, 8 heads of 64,
# 12 layers
CONF_T, CONF_H, CONF_D = 767, 8, 64
# heads past 64: a conformer of d_model 512 with 4 heads (K1 and K2 in [3],
# [3b]; the card-vs-CPU pin in [4b])
WIDE_HEAD, WIDE_HEADS = 128, 4
# the streaming stacks of Zipformer2Config(causal=True) (chunk 32, left 128):
# (T = stack chunk, S = stack left + T, H, layers); a lane's kv_start is in
# [0, S - T].  Conformer: ConformerConfig(causal=True), T=16, S=64+16.
_ZS = Zipformer2Config(causal=True)
STREAM_STACKS = [(_ZS.stack_chunk(i), _ZS.stack_left(i) + _ZS.stack_chunk(i), _ZS.num_heads[i],
                  _ZS.num_encoder_layers[i]) for i in range(_ZS.num_stacks)]
STREAM_LANES = 16
# zipformer v1: ZipformerConfig() at 16 x 30 s (t_pad 3072 -> 1532 embed-rate
# frames), (T, layers) per stack at downsampling 1,2,4,8,2, 8 heads, q head
# 24 (192 / 8), pos_dim 4; ZipformerConfig(causal=True) (chunk 16, left 64)
# streaming: (T = stack chunk, S = stack left + T, layers)
_V1, _V1S = ZipformerConfig(), ZipformerConfig(causal=True)
V1_QD, V1_H = _V1.attention_dims[0] // _V1.num_heads[0], _V1.num_heads[0]
V1_STACKS = [(-(-_V1.embed_len(3072) // d), n)
             for d, n in zip(_V1.downsampling_factors, _V1.num_encoder_layers)]
V1_STREAM_STACKS = [(_V1S.stack_chunk(i), _V1S.stack_left(i) + _V1S.stack_chunk(i),
                     _V1S.num_encoder_layers[i]) for i in range(_V1S.num_stacks)]

F32_ATOL = 1e-5  # kernel vs plain, float32: summation order only
BF16_ULPS = 1    # K1 vs plain, bf16 probs: both round one f32 value
# K2 vs plain, bf16: the kernel rounds the UNNORMALISED probabilities to
# bf16 before P.V, the plain version the normalised ones; each side is within
# 2^-9 * max|v| of the exact product, so they differ by at most 2^-8 * max|v|,
# then both round the output once (one bf16 ulp)
K2_PROB_ROUNDING = 2.0**-8

# (what it breaks, file, text, replacement, the phase that must catch it)
MUTATIONS = [
    ("K2 skew offset S-1 instead of T-1", "k2transducerasr_tpu_torch/csrc/relpos_attn_ctx.cu",
     "rp::pos_window_first(T, t0, 0)", "rp::pos_window_first(S, t0, 0)", "phase_k2"),
    ("K1 pass 2 without the division by the row sum",
     "k2transducerasr_tpu_torch/csrc/relpos_attn_probs.cu", " * inv_l[r];", ";", "phase_k1"),
    ("K1 bf16 without the kv_start mask", "k2transducerasr_tpu_torch/csrc/relpos_attn_probs.cu",
     "rp::KeyMask mask(S, a.lens, a.kv_start,", "rp::KeyMask mask(S, a.lens, nullptr,", "phase_k1"),
    ("greedy ties broken toward the higher index", "k2transducerasr_tpu_torch/csrc/rnnt_cluster.cuh",
     "(v == bv && i < bi)", "(v == bv && i > bi)", "phase_greedy"),
    ("greedy extra_skip_sos ignored", "k2transducerasr_tpu_torch/csrc/rnnt_greedy.cu",
     "(a.skip_sos && y == 1)", "(false && y == 1)", "phase_greedy"),
    ("greedy timestamps without frame_offset", "k2transducerasr_tpu_torch/csrc/rnnt_greedy.cu",
     "= offset + t + f;", "= t + f;", "phase_greedy"),
    ("greedy argmax without the last rank's vocabulary share",
     "k2transducerasr_tpu_torch/csrc/rnnt_greedy.cu",
     "for (int src = 0; src < kCL; ++src)", "for (int src = 0; src < kCL - 1; ++src)",
     "phase_greedy"),
    ("beam extra_skip_sos ignored", "k2transducerasr_tpu_torch/csrc/rnnt_beam.cu",
     "(a.skip_sos && v == 1)", "(false && v == 1)", "phase_beam"),
    ("beam timestamps without frame_offset", "k2transducerasr_tpu_torch/csrc/rnnt_beam.cu",
     "a.timestamps[dst + pos] = s.offset[p] + t;", "a.timestamps[dst + pos] = t;",
     "phase_beam"),
    ("beam windows never folded", "k2transducerasr_tpu_torch/csrc/rnnt_beam.cu",
     "(t == te - 1 ? 2 : 0)", "0", "phase_beam"),
    ("beam log-sum-exp without the last rank's share",
     "k2transducerasr_tpu_torch/csrc/rnnt_beam.cu",
     "for (int q = 0; q < kCL; ++q) S +=", "for (int q = 0; q < kCL - 1; ++q) S +=",
     "phase_beam"),
    ("bias_swoosh slope 0.07 instead of 0.08", "k2transducerasr_tpu_torch/csrc/bias_swoosh.cu",
     "__fmul_rn(0.08f, z)", "__fmul_rn(0.07f, z)", "phase_swoosh"),
    ("bias_swoosh SwooshL shifted by 3 instead of 4",
     "k2transducerasr_tpu_torch/csrc/bias_swoosh.cu", "kind == 0 ? 4.f : 1.f",
     "kind == 0 ? 3.f : 1.f", "phase_swoosh"),
]


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
    """Median time of one fn() call in ms, CUDA events around each call: the
    host's time to launch it from an empty queue included."""
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


def host_us(fn, reps: int = 20) -> float:
    """Mean host time of one fn() call in microseconds, the calls queued
    back to back with no sync between them (the device's time excluded
    while the queue has room)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_ms(fn, reps: int, warm: int = 2) -> float:
    """Device time of one fn() call in ms: CUDA events around ``reps`` calls
    queued behind a spin kernel (torch.cuda._sleep) that holds the stream
    until the last call is queued, so the window holds the calls' device
    work back to back and none of the host's time to prepare and launch,
    which the card spends idle when the queue is empty.  The spin is made
    longer until the start event is still pending once every call is
    queued.  Needs no profiler."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22  # about 2 ms at the H100's clock
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise AssertionError("device_ms: the spin kernel ended before the calls were queued")


def streams_for(rec, pcms):
    out = []
    for x in pcms:
        s = rec.create_offline_stream()
        s.add_samples(x)
        out.append(s)
    return out


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def counters_since(before: dict) -> dict:
    """What each of the port's counters (``profiling.counters``) rose by
    since the reading ``before``."""
    return {k: v - before.get(k, 0) for k, v in profiling.counters().items()}


def path_kernels(spec, method=GREEDY) -> set:
    """The kernels a run of the family launches: its attention kernel,
    bias_swoosh for a zipformer2 encoder, and for a transducer rnnt_greedy
    under greedy search and rnnt_beam under modified beam search."""
    search = {GREEDY: {"rnnt_greedy"}, BEAM: {"rnnt_beam"}}.get(method, set())
    return (({spec["kernel"]} - {None}) | (search if spec["greedy"] else set())
            | ({"bias_swoosh"} if spec["swoosh"] else set()))


def search_kernel(spec, method):
    """The search kernel a run of the family launches, or None (CTC)."""
    return next(iter(path_kernels(spec, method) & set(SEARCH_PATHS)), None)


def family_launches(what, spec, counts, method=GREEDY) -> int:
    """A run of one family launched each kernel of its path and no other;
    the search kernel's launches are recorded in GREEDY_PATHS or BEAM_PATHS
    under ``what``, bias_swoosh's in SWOOSH_PATHS.  Returns the family's
    attention kernel's launches."""
    want = path_kernels(spec, method)
    if {k for k, n in counts.items() if n} != want:
        raise AssertionError(f"{what} launched {counts}; expected {sorted(want) or 'none'}")
    search = search_kernel(spec, method)
    if search:
        SEARCH_PATHS[search][what] = counts[search]
    if spec["swoosh"]:
        SWOOSH_PATHS[what] = counts["bias_swoosh"]
    return counts.get(spec["kernel"], 0)


def counts_of(**launches) -> dict:
    """Every kernel's launch count, 0 but where given."""
    return {k: launches.get(k, 0) for k in KERNELS}


def check_conv_tf32(what, spec, recorded, ran, replays) -> None:
    """The family's convolutions with cuDNN's TF32 allowed
    (``ops/layers.conv_tf32``): ``recorded`` per replay by the capture (its
    entry's last count) and ``ran`` in ``replays`` timed replays (the rise
    of ``conv_tf32.launches``), FAMILIES' ``convs`` a replay."""
    want = spec["convs"]
    if recorded != want or ran != want * replays:
        raise AssertionError(f"{what}: conv_tf32 {recorded} a replay recorded, {ran} in "
                             f"{replays} replays; expected {want} a replay")
    CONV_TF32_PATHS[what] = ran


def replay_counts(spec, search) -> dict:
    """Each kernel's launches in one flagship batch or streaming step of the
    family with the search kernel ``search`` (None: CTC)."""
    return counts_of(**{spec["kernel"] or "none": spec["per_batch"], search or "none": 1,
                        "bias_swoosh": spec["swoosh"]})


def reset_peak_memory():
    """Start a peak-memory window holding only what is alive: an earlier
    phase's recognizer and its streams refer to each other, so their bundle
    stays on the card until the cycle collector runs."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def bound(nbytes, ops, dtype, bw):
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


BUILD_LOG: list[str] = []  # what nvcc printed in [2] (-Xptxas -v)


def phase_build():
    t0 = time.time()
    paths, BUILD_LOG[:] = _captured(lambda: cuda_build.build(*KERNELS, verbose=True))
    secs = time.time() - t0
    log("\n".join(BUILD_LOG))
    log(f"[2] built {', '.join(os.path.relpath(p, REPO) for p in paths.values())} "
        f"in {secs:.1f} s (loaded at first launch)")
    return secs


def _k1_inputs(b, t, s, h, dtype, seed, qd=QD, pd=PD):
    """Random operands; a head wider than 64 scaled by sqrt(32 / width), as
    a model scales its queries, so its scores are as large as at 32 wide."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    sq, sp = ((32 / w) ** 0.5 if w > 64 else 1.0 for w in (qd, pd))
    q = (torch.randn((b, t, h, qd), generator=g, device=dev) * sq).to(dtype)
    k = torch.randn((b, s, h, qd), generator=g, device=dev).to(dtype)
    pq = (torch.randn((b, t, h, pd), generator=g, device=dev) * sp).to(dtype)
    pk = torch.randn((t + s - 1, h, pd), generator=g, device=dev).to(dtype)
    return q, k, pq, pk, _ragged_lens(b, s)


def _ragged_lens(b, s):
    lens = torch.tensor([s - (i * s) // (2 * b) for i in range(b)], device="cuda",
                        dtype=torch.int32)
    lens[-1] = 1  # a lane with one valid key
    return lens


def _k1_bytes_ops(b, t, s, h, in_dtype, out_dtype, qd=QD, pd=PD):
    ie = torch.finfo(in_dtype).bits // 8
    oe = torch.finfo(out_dtype).bits // 8
    nbytes = (b * t * h * qd + b * s * h * qd + b * t * h * pd + (t + s - 1) * h * pd) * ie \
        + 2 * 4 * b + b * h * t * s * oe
    ops = 2 * b * h * t * s * (qd + pd)
    return nbytes, ops


def _max_err(out, ref, dtype):
    """(max abs error, ok) against the stated tolerance."""
    d = (out.float() - ref.float()).abs()
    err = float(d.max())
    if dtype == torch.float32:
        return err, err <= F32_ATOL
    return err, bool((d <= BF16_ULPS * _bf16_ulp(ref)).all())


def _bf16_ulp(ref):
    """One bf16 ulp of each plain value: 2^(floor(log2|ref|) - 7)."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _kv_start(b, t, s):
    """Per-lane first valid key, drawn from [0, S - T] (a streaming lane's
    cache gating), with lane 0 at 0 (every cache slot filled) and lane 1 at
    S - T (a fresh stream: only the chunk's own keys)."""
    kv = torch.randint(0, s - t + 1, (b,), device="cuda", dtype=torch.int32,
                       generator=torch.Generator(device="cuda").manual_seed(b + s))
    kv[0], kv[1] = 0, s - t
    return kv


def phase_k1(bw):
    """K1 against its plain version at every shape its main paths give it:
    zipformer2's (qd 32) and zipformer v1's (qd 24, 8 heads), offline and
    streaming, float32 and bf16.  Each row carries the family whose main
    path makes those calls (``layers`` per batch, ``stream_layers`` per
    step)."""
    rows = []
    worst = 0.0
    # (name, family, B, T, S, H, qd, dtype, kwargs, layers, stream layers)
    cases = []
    for si, (t, h, layers) in enumerate(FLAGSHIP_STACKS):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"stack{si}", "zipformer2", FLAGSHIP_B, t, t, h, QD, dtype, {},
                          layers, 0))
    t0 = FLAGSHIP_STACKS[0][0]
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("stack0-chunk32-left128", "zipformer2", FLAGSHIP_B, t0, t0, 4, QD, dtype,
                      {"chunk": 32, "left": 128}, 0, 0))
    # the streaming main path: one call per layer and step at each stack's
    # (T, S), kv_start per lane
    for si, (t, s, h, layers) in enumerate(STREAM_STACKS):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"stream-stack{si}-T{t}-S{s}", "zipformer2", STREAM_LANES, t, s, h, QD,
                          dtype, {"kv_start": True}, 0, layers))
    # past the 11,249 keys the float32 body once held in shared memory: both
    # bodies tile the key axis and take any S
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("long-T32-S12000", "zipformer2", FLAGSHIP_B, 32, 12000, 4, QD, dtype, {},
                      0, 0))
    # zipformer v1: q head 24 (the bf16 body pads it to 32), T down to 2
    for si, (t, layers) in enumerate(V1_STACKS):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"v1-stack{si}", "zipformer", FLAGSHIP_B, t, t, V1_H, V1_QD, dtype, {},
                          layers, 0))
    for si, (t, s, layers) in enumerate(V1_STREAM_STACKS):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"v1-stream-stack{si}-T{t}-S{s}", "zipformer", STREAM_LANES, t, s,
                          V1_H, V1_QD, dtype, {"kv_start": True}, 0, layers))
    # heads past 64 (the chunked bodies; no main path of the repo's configs
    # gives them): q and pos heads of WIDE_HEAD at zipformer2's stack-1 shape
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((f"wide-qd{WIDE_HEAD}-pd{WIDE_HEAD}", "zipformer2", FLAGSHIP_B,
                      FLAGSHIP_STACKS[1][0], FLAGSHIP_STACKS[1][0], 4, WIDE_HEAD, dtype,
                      {"pd": WIDE_HEAD}, 0, 0))

    for name, family, b, t, s, h, qd, dtype, kw, layers, stream_layers in cases:
        kw = dict(kw)
        pd = kw.pop("pd", PD)
        q, k, pq, pk, lens = _k1_inputs(b, t, s, h, dtype, seed=len(rows), qd=qd, pd=pd)
        if kw.pop("kv_start", False):
            kw["kv_start"] = _kv_start(b, t, s)
        out = AC.relpos_attn_probs(q, k, pq, pk, lens, **kw)
        ref = AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw)
        torch.cuda.synchronize()
        err, ok = _max_err(out, ref, dtype)
        if not ok:
            raise AssertionError(f"K1 {name} {dtype}: kernel disagrees with plain (max {err})")
        worst = max(worst, err)
        def kernel():
            return AC.relpos_attn_probs(q, k, pq, pk, lens, **kw)

        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, reps=20)
        host = host_us(kernel)
        plain_ms = cuda_ms(lambda: AC.relpos_attn_probs_reference(q, k, pq, pk, lens, **kw),
                           reps=5, warm=1)
        bound_ms, bound_by = bound(*_k1_bytes_ops(b, t, s, h, dtype, dtype, qd=qd, pd=pd), dtype,
                                   bw)
        rows.append({"case": name, "family": family, "dtype": str(dtype).split(".")[-1],
                     "B": b, "T": t, "S": s, "H": h, "qd": qd, "pd": pd, "layers": layers,
                     "stream_layers": stream_layers, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "host_us": host, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"[3] K1 {name:28s} {rows[-1]['dtype']:8s} B={b} T={t} S={s} H={h} qd={qd} pd={pd}: "
            f"max_err {err:.3e} ok | kernel {ms:.4f} ms (device {dev_ms:.4f}, host "
            f"{host:.1f} us) | plain {plain_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) "
            f"| {bound_ms / ms:.1%} of bound ({bound_ms / dev_ms:.1%} of device time)")
        del q, k, pq, pk, lens, out, ref
        torch.cuda.empty_cache()
    return rows, worst


def _k2_inputs(b, t, s, h, d, vd, dtype, seed):
    """Conformer-like operands: q and pos_q carry the folded 1/sqrt(d)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = (torch.randn((b, t, h, d), generator=g, device=dev) * d**-0.5).to(dtype)
    k = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
    pq = (torch.randn((b, t, h, d), generator=g, device=dev) * d**-0.5).to(dtype)
    pk = torch.randn((t + s - 1, h, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, h, vd), generator=g, device=dev).to(dtype)
    return q, k, pq, pk, v


def _k2_err(out, ref, v, dtype):
    d = (out.float() - ref.float()).abs()
    err = float(d.max())
    if dtype == torch.float32:
        return err, err <= F32_ATOL
    tol = K2_PROB_ROUNDING * float(v.float().abs().max()) + _bf16_ulp(ref)
    return err, bool((d <= tol).all())


def _k2_bytes_ops(b, t, s, h, d, vd, dtype):
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * t * h * d + b * s * h * d + (t + s - 1) * h * d + b * s * h * vd
              + b * t * h * vd) * e + 2 * 4 * b
    ops = 2 * b * h * t * s * (2 * d + vd)
    return nbytes, ops


def _sdpa_backend(fn) -> str:
    """Which SDPA backend ran fn(), from the device kernels' names."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    # cuDNN's kernel names also carry "flash": look for it first
    for tag, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient")):
        hits = [n for n in names if tag in n.lower()]
        if hits:
            return f"{backend}: {hits[0][:80]}"
    return f"math: {names[:3]}" if names else "not identified (no device kernels seen)"


def phase_k2(bw):
    """K2 against its plain version, and SDPA's time on the same function
    (the skewed position term with NEG_INF at masked keys as its bias, built
    before the timed call and not timed)."""
    b, t = FLAGSHIP_B, CONF_T
    layers = FAMILIES["conformer"]["per_batch"]
    scfg = FAMILIES["conformer"]["stream_cfg"]()
    ts, ss = scfg.chunk_size, scfg.left_context + scfg.chunk_size
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("flagship-ragged", t, t, CONF_D, dtype, {"lens": True}, layers, 0))
        cases.append(("flagship-chunk16-left64", t, t, CONF_D, dtype,
                      {"lens": True, "chunk": 16, "left": 64}, 0, 0))
        # the streaming main path: every layer, every step; kv_start in [0, 64]
        cases.append((f"kv_start-T{ts}-S{ss}", ts, ss, CONF_D, dtype, {"kv_start": True}, 0,
                      scfg.num_layers))
    cases.append(("flagship-vd32", t, t, 32, torch.bfloat16, {"lens": True}, 0, 0))
    # heads past 64 (the chunked bodies): a conformer of d_model 512 with 4
    # heads of WIDE_HEAD, as converted from a 4-head export
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((f"heads-{WIDE_HEADS}x{WIDE_HEAD}", t, t, WIDE_HEAD, dtype,
                      {"lens": True, "h": WIDE_HEADS, "d": WIDE_HEAD}, 0, 0))

    rows = []
    worst = 0.0
    for name, tq, s, vd, dtype, kw, n_layers, stream_layers in cases:
        kw = dict(kw)
        h, d = kw.pop("h", CONF_H), kw.pop("d", CONF_D)
        q, k, pq, pk, v = _k2_inputs(b, tq, s, h, d, vd, dtype, seed=100 + len(rows))
        lens = _ragged_lens(b, s) if kw.pop("lens", False) else None
        if kw.pop("kv_start", False):
            kw["kv_start"] = _kv_start(b, tq, s)
        out = AC.relpos_attn_ctx(q, k, pq, pk, v, lens, **kw)
        ref = AC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, **kw)
        torch.cuda.synchronize()
        err, ok = _k2_err(out, ref, v, dtype)
        if not ok:
            raise AssertionError(f"K2 {name} {dtype}: kernel disagrees with plain (max {err})")
        worst = max(worst, err)
        def kernel():
            return AC.relpos_attn_ctx(q, k, pq, pk, v, lens, **kw)

        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, reps=20)
        host = host_us(kernel)
        plain_ms = cuda_ms(lambda: AC.relpos_attn_ctx_reference(q, k, pq, pk, v, lens, **kw),
                           reps=5, warm=1)
        bias = AC._masked_scores(torch.zeros_like(q), k, pq, pk, lens, kw.get("chunk", 0),
                                 kw.get("left", 0), kw.get("kv_start")).to(dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=1.0)

        lib_ms = cuda_ms(sdpa, reps=20)
        lib_dev_ms = device_ms(sdpa, reps=20)
        lib_err = float((sdpa().transpose(1, 2).float() - ref.float()).abs().max())
        backend = _sdpa_backend(sdpa)
        bound_ms, bound_by = bound(*_k2_bytes_ops(b, tq, s, h, d, vd, dtype), dtype, bw)
        rows.append({"case": name, "family": "conformer", "dtype": str(dtype).split(".")[-1],
                     "B": b, "T": tq, "S": s, "H": h, "d": d, "vd": vd, "layers": n_layers,
                     "stream_layers": stream_layers,
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "host_us": host,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "library_backend": backend})
        log(f"[3b] K2 {name:24s} {rows[-1]['dtype']:8s} B={b} T={tq} S={s} H={h} d={d} "
            f"vd={vd}: max_err {err:.3e} ok | kernel {ms:.4f} ms (device {dev_ms:.4f}, host "
            f"{host:.1f} us) | plain {plain_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound ({bound_ms / dev_ms:.1%} of device time) | "
            f"SDPA {lib_ms:.4f} ms (device {lib_dev_ms:.4f}) "
            f"[{backend}; bias build not timed; max diff vs plain {lib_err:.3e}]")
        del q, k, pq, pk, v, lens, out, ref, bias, qh, kh, vh
        torch.cuda.empty_cache()
    return rows, worst


# [3c] the greedy search kernel.  GREEDY_T: encoder frames of a 30 s lane of
# Zipformer2Config() (t_pad 3072 -> 1532 at the first stack -> 766 out);
# GREEDY_STEPS streaming steps are chained through the kernel's state
GREEDY_T = (FLAGSHIP_STACKS[0][0] + 1) // 2
GREEDY_STEPS = 8
GREEDY_ULPS = 2.0  # bf16: the tie-aware replay's margin (decode/rnnt_greedy.py)
GREEDY_MAX_TOKENS = 1024  # OfflineRecognizer's default buffer
GREEDY_FIELDS = ("hyp", "tokens", "timestamps", "count", "trailing_blanks")
GREEDY_RATE = 1 / 6  # emissions per frame of the blank-bias case (a trained model's order)
GREEDY_BIG_VOCAB = 5500  # a real BPE vocabulary: the joiner's weights streamed
GREEDY_WIDE, GREEDY_WIDE_CTX = 1536, 10  # past the caps the kernel once had (1024, 8)
# the one-block-per-lane kernel this design replaced, at the same cases
# (PERF.md §6, on an NVIDIA H100 80GB HBM3 at 700.00 W; that kernel is gone,
# so not re-timed)
GREEDY_ONE_BLOCK = ("the one-block-per-lane kernel, PERF.md §6 (NVIDIA H100 80GB HBM3, "
                    "700.00 W): offline bf16 20.80 ms (device 19.88), float32 50.30 (49.67), "
                    "streaming step 0.559 (0.411)")


def _wide_search_models(enc_dim):
    """A decoder and joiner GREEDY_WIDE wide with GREEDY_WIDE_CTX tokens of
    context and vocab 500, initialised from numpy seed 0 (the port's
    init_params), on the card."""
    rng = np.random.default_rng(0)
    cfg = DecoderConfig(vocab_size=500, decoder_dim=GREEDY_WIDE, context_size=GREEDY_WIDE_CTX)
    dec = decoder_mod.init_params(rng, cfg)
    join = joiner_mod.init_params(rng, joiner_mod.JoinerConfig(enc_dim, GREEDY_WIDE, GREEDY_WIDE,
                                                               500))
    return params_from_numpy(dec, "cuda"), params_from_numpy(join, "cuda"), cfg


def _greedy_lens(b, t):
    """Ragged valid frames: lane i loses i/2b of T, the last lane has none."""
    lens = torch.tensor([t - (i * t) // (2 * b) for i in range(b)], device="cuda")
    lens[-1] = 0
    return lens


def _greedy_bytes_ops(ops, b, frames, emissions):
    """The least bytes and operations of one search, counted from what this
    run's data needs: the valid frames of enc_proj read once, the two
    weights and biases once, the context-table rows the emissions gather
    (at most the whole tables), the small state (contexts, decoder outputs,
    counts, trailing blanks) read and written once, the lanes' lengths and
    offsets read, and 16 bytes written per emission (its token and
    timestamp); a joiner row per valid frame (2 J V) and a decoder refresh
    per emission (2 D J)."""
    c, v, d = ops.tables.shape
    j = ops.joiner_dim
    e = 4 if ops.compute_dtype is None else 2
    weights = (j * v + d * j) * e + (j + v) * 4
    tables = min(c * v * d, emissions * c * d) * 4
    state = b * c * 8 + b * j * e + 2 * b * 8
    nbytes = frames * j * e + weights + tables + 2 * state + 2 * b * 8 + 16 * emissions
    return nbytes, 2 * frames * j * v + 2 * emissions * d * j


def _greedy_dyadic(dtype, v=500, d=512, j=512, ctx=2, seed=0):
    """A decoder and joiner of small multiples of powers of two, and an
    encoder-frame maker, such that every float32 sum of the search is exact
    in any order: then the kernel equals the plain version bit for bit and
    its tie rule shows.  Output columns 4 .. V-1 come in equal pairs (exact
    ties); blank and sos carry large biases (blank runs, sos frames).  The
    frames are +-16 .. 28 for float32 (tanh exactly +-1), +-1 .. 1.75 for
    bf16 (the decoder state moves the logits)."""
    rng = np.random.default_rng(seed)

    def q(lo, hi, scale, shape):
        return torch.from_numpy((rng.integers(lo, hi + 1, shape) * scale).astype(np.float32))

    cfg = DecoderConfig(vocab_size=v, decoder_dim=d, context_size=ctx)
    dp = {"embedding": {"table": q(-2, 2, 0.25, (v, d))},
          "conv": {"w": q(-1, 1, 0.25, (ctx, 4, d))}}
    w_out, b_out = q(-2, 2, 0.125, (j, v)), q(-2, 2, 0.125, (v,))
    pairs = (v - 4) // 2
    w_out[:, 5:5 + 2 * pairs:2] = w_out[:, 4:4 + 2 * pairs:2]
    b_out[5:5 + 2 * pairs:2] = b_out[4:4 + 2 * pairs:2]
    b_out[0] += 10.0
    b_out[1] += 9.0
    jp = {"decoder_proj": {"w": q(-1, 1, 2.0**-7, (d, j)), "b": q(-1, 1, 2.0**-6, (j,))},
          "output": {"w": w_out, "b": b_out}}
    tree = lambda x: {k: {n: a.numpy() for n, a in p.items()} for k, p in x.items()}  # noqa: E731
    big = 16.0 if dtype is None else 1.0

    def frames(b, t):
        mag = big * (1.0 + torch.from_numpy(rng.integers(0, 4, (b, t, j))).float() * 0.25)
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], (b, t, j))).float()
        x = (mag * sign).cuda()
        return x if dtype is None else x.to(dtype)

    return params_from_numpy(tree(dp), "cuda"), params_from_numpy(tree(jp), "cuda"), cfg, frames


def _greedy_compare(case, dtype, dec, cfg, join, st, enc, lens, offset, sos, got, exact):
    """The kernel's state ``got`` against the plain version from ``st``:
    ``exact`` (dyadic inputs) every field bit for bit; float32 every field
    but dec_proj exactly and dec_proj within F32_ATOL; bf16 the tie-aware
    replay at GREEDY_ULPS.  Returns (max abs dec_proj error, frames decided
    otherwise than the plain argmax)."""
    def fail(detail):
        raise AssertionError(f"rnnt_greedy {case}: kernel disagrees with plain ({detail})")

    if exact or dtype is None:
        want = rnnt_greedy.greedy_frames_skip_reference(dec, cfg, join, st, enc, lens, offset,
                                                        sos, dtype)
        for f in GREEDY_FIELDS:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                lanes = (getattr(got, f) != getattr(want, f)).reshape(len(lens), -1).any(1)
                fail(f"{f} differs in lanes {lanes.nonzero()[:, 0].tolist()}")
        err = float((got.dec_proj.float() - want.dec_proj.float()).abs().max())
        if err > (0.0 if exact else F32_ATOL):
            fail(f"dec_proj max abs error {err}")
        return err, 0
    res = tie_aware_replay(dec, cfg, join, st, enc, lens, offset, got, sos, dtype, GREEDY_ULPS)
    if not res.ok:
        fail(f"tie-aware replay: {res.reason}")
    return 0.0, res.differing


def _greedy_row(case, dtype, ops, st, got, enc, lens, bw, kernel, plain, err, differing,
                exact):
    b, t = enc.shape[:2]
    frames = int(lens.clamp(max=t).sum())
    emissions = int((got.count - st.count).sum())
    ms = cuda_ms(kernel, reps=10)
    dev_ms = device_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=2, warm=1)
    peak_dtype = torch.float32 if dtype is None else dtype
    bound_ms, bound_by = bound(*_greedy_bytes_ops(ops, b, frames, emissions), peak_dtype, bw)
    row = {"case": case, "dtype": str(peak_dtype).split(".")[-1], "B": b, "T": t,
           "J": ops.joiner_dim, "V": ops.vocab, "frames": frames, "emissions": emissions,
           "max_abs_err": err, "differing_frames": differing, "exact": exact, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[3c] rnnt_greedy {case:20s} {row['dtype']:8s} B={b} T={t} J={row['J']} V={row['V']}: "
        f"{frames} frames, {emissions} emissions, "
        + ("bit for bit" if exact else f"max dec_proj err {err:.2e}" if dtype is None else
           f"replay ok at {GREEDY_ULPS:g} ulps, {differing} frames decided otherwise than the "
           f"plain argmax")
        + f" | kernel {ms:.4f} ms (device {dev_ms:.4f}) | plain {plain_ms:.2f} ms | bound "
        f"{bound_ms:.5f} ms ({bound_by}) | {bound_ms / ms:.2%} of bound")
    return row


def _ptxas(kernel) -> str:
    """What -Xptxas -v printed in [2] for a search's two kernels (registers,
    stack, spills); ``kernel`` is the template's name."""
    out, mine = [], False
    for line in BUILD_LOG:
        if "Compiling entry function" in line:
            mine = kernel in line
            if mine:
                out.append("bf16:" if "ILb1E" in line else "float32:")
        elif mine and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return " ".join(out) or "not rebuilt in [2]"


def _greedy_plans(cases) -> dict:
    """[3c]'s first line: the cluster, each case's shared memory per block
    and where its weights live (rnnt_greedy.kernel_plan), the clusters that
    run at once, and the registers and spills.  Returns the plans by case."""
    plans, parts = {}, []
    for name, dtype, j, d, v, c in cases:
        p = rnnt_greedy.kernel_plan(j, d, v, dtype, c)
        dt = "float32" if dtype is None else "bf16"
        plans[f"{name} {dt}"] = p
        parts.append(
            f"{name} {dt} (J={j} D={d} V={v} C={c}): {p['smem_bytes']} B/block, "
            f"rings of {p['ring_stages']}, W_out "
            f"{p['resident_ntiles']}/{p['ntiles_per_rank']} n-tiles resident"
            + (f" + stages of {p['stage_ntiles']}" if p["stage_ntiles"] else "")
            + f", decoder_proj {p['resident_chunks']}/{p['chunks_per_rank']} chunks"
            + (f" + stages of {p['stage_chunks']}" if p["stage_chunks"] else "")
            + f", {p['max_active_clusters']} clusters at once, {p['registers']} registers, "
            f"{p['local_bytes']} B local")
    log(f"[3c] rnnt_greedy: one cluster of {rnnt_greedy.CLUSTER} blocks x 512 threads per lane "
        f"| " + " | ".join(parts) + f" | ptxas -v: {_ptxas('rnnt_greedy_kernel')}")
    return plans


def _joiner_at_rate(dec, cfg, join, enc, lens, dtype, rate):
    """A copy of the joiner whose blank bias is raised, by bisection on the
    kernel's own search over ``enc``, until about ``rate`` of the valid
    frames emit.  Returns (joiner, the bias added, the rate reached)."""
    zero = torch.zeros(len(lens), dtype=torch.int64, device="cuda")
    frames = float(lens.sum())
    out = join["output"]
    b0 = out["b"] if "b" in out else torch.zeros(out["w"].shape[1], device="cuda")

    def with_bias(delta):
        j2 = join.tree()
        j2["output"]["b"] = b0.clone()
        j2["output"]["b"][cfg.blank_id] += delta
        return j2

    def emitted(j2):
        st = rnnt_greedy.init_state(dec, cfg, j2, len(lens), GREEDY_MAX_TOKENS, dtype)
        got = rnnt_greedy.greedy_frames_skip(dec, cfg, j2, st, enc, lens, zero, False, dtype)
        return float(got.count.sum()) / frames

    lo, hi = 0.0, 8.0
    for _ in range(12):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if emitted(with_bias(mid)) > rate else (lo, mid)
    j2 = with_bias(hi)
    return j2, hi, emitted(j2)


def phase_greedy(bw):
    """[3c] rnnt_greedy against its plain version at the main paths' shapes,
    on the decoder and joiner of Zipformer2Config(causal=True) from seed 0
    (vocab 500, decoder and joiner 512 wide, context 2) and random encoder
    frames through its encoder projection; then on dyadic inputs.  Offline:
    16 lanes x GREEDY_T frames from frame 0, extra_skip_sos False, every
    lane full (the main path's batch, the headline) and ragged
    (``_greedy_lens``).  Streaming: 16 lanes x one window's encoder frames, frame_offset per lane,
    extra_skip_sos True, GREEDY_STEPS steps chained through the kernel's
    state, each held against the plain version from the same state.  Offline
    bf16 also with the blank bias raised until about GREEDY_RATE of the
    frames emit (``_joiner_at_rate``: long blank runs, the staged rows
    follow), and with the decoder and joiner of a GREEDY_BIG_VOCAB
    vocabulary (seed 0), whose weights do not fit the cluster and stream.
    Returns (the rows, the kernel's plans)."""
    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=True), vocab_size=500,
                                seed=0, device="cuda")
    dec, join, cfg = bundle.decoder, bundle.joiner, bundle.decoder_cfg
    chunk = get_encoder("zipformer2").output_chunk_len(bundle.encoder_cfg)
    enc_dim = join["encoder_proj"]["w"].shape[0]
    j_dim, d_dim = join["decoder_proj"]["w"].shape[1], join["decoder_proj"]["w"].shape[0]
    b = FLAGSHIP_B
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    plans = _greedy_plans([("flagship", dt, j_dim, d_dim, 500, 2) for dt in (None, torch.bfloat16)]
                          + [("vocab-5500", torch.bfloat16, j_dim, d_dim, GREEDY_BIG_VOCAB, 2)]
                          + [(f"wide-{GREEDY_WIDE}", dt, GREEDY_WIDE, GREEDY_WIDE, 500,
                              GREEDY_WIDE_CTX) for dt in (None, torch.bfloat16)])

    def frames(t, dtype, joiner=join):
        x = torch.randn((b, t, enc_dim), generator=g, device="cuda")
        with torch.inference_mode():
            return joiner_mod.project_encoder(joiner, x, dtype)

    def run(case, dtype, dec, cfg, join, make, t, sos, steps, exact, ragged=True):
        ops = rnnt_greedy.greedy_operands(dec, cfg, join, dtype)
        st = rnnt_greedy.init_state(dec, cfg, join, b, GREEDY_MAX_TOKENS, dtype)
        offset = (torch.arange(b, device="cuda") * 997) if steps > 1 else torch.zeros(
            b, dtype=torch.int64, device="cuda")
        worst, differing = 0.0, 0
        for step in range(steps):
            enc = make(t, dtype)
            lens = _greedy_lens(b, t) if ragged else torch.full((b,), t, device="cuda")
            if steps > 1:  # streaming: lanes that skip a step, or take part of a window
                lens = torch.roll(lens, step)
            with exact_f32():
                got = rnnt_greedy.greedy_frames_skip(dec, cfg, join, st, enc, lens, offset, sos,
                                                     dtype, operands=ops)
                torch.cuda.synchronize()
                err, diff = _greedy_compare(f"{case} step {step}", dtype, dec, cfg, join, st,
                                            enc, lens, offset, sos, got, exact)
            worst, differing = max(worst, err), differing + diff
            if step == steps - 1:
                def kernel(st=st, enc=enc, lens=lens, offset=offset):
                    return rnnt_greedy.greedy_frames_skip(dec, cfg, join, st, enc, lens, offset,
                                                          sos, dtype, operands=ops)

                def plain(st=st, enc=enc, lens=lens, offset=offset):
                    return rnnt_greedy.greedy_frames_skip_reference(dec, cfg, join, st, enc,
                                                                    lens, offset, sos, dtype)

                with exact_f32():
                    rows.append(_greedy_row(case, dtype, ops, st, got, enc, lens, bw, kernel,
                                            plain, worst, differing, exact))
            st, offset = got, offset + lens

    for dtype in (None, torch.bfloat16):
        run("offline", dtype, dec, cfg, join, frames, GREEDY_T, False, 1, False, ragged=False)
        run("offline-ragged", dtype, dec, cfg, join, frames, GREEDY_T, False, 1, False)
        run("streaming", dtype, dec, cfg, join, frames, chunk, True, GREEDY_STEPS, False)
    for dtype in (None, torch.bfloat16):
        ddec, djoin, dcfg, make = _greedy_dyadic(dtype)
        run("dyadic-offline", dtype, ddec, dcfg, djoin, lambda t, _: make(b, t), GREEDY_T,
            False, 1, True)
        run("dyadic-streaming", dtype, ddec, dcfg, djoin, lambda t, _: make(b, t), chunk, True,
            GREEDY_STEPS, True)
    bf16 = torch.bfloat16
    full = torch.full((b,), GREEDY_T, device="cuda")
    with torch.inference_mode():
        rate_join, bias, rate = _joiner_at_rate(dec, cfg, join, frames(GREEDY_T, bf16), full, bf16,
                                                GREEDY_RATE)
    log(f"[3c] rnnt_greedy offline-1in6: blank bias +{bias:.4f} gives {rate:.4f} emissions "
        f"per frame")
    run("offline-1in6", bf16, dec, cfg, rate_join, frames, GREEDY_T, False, 1, False,
        ragged=False)
    del bundle
    big = ModelBundle.random("zipformer2", Zipformer2Config(causal=True),
                             vocab_size=GREEDY_BIG_VOCAB, seed=0, device="cuda")
    run("offline-v5500", bf16, big.decoder, big.decoder_cfg, big.joiner,
        lambda t, dtype: frames(t, dtype, big.joiner), GREEDY_T, False, 1, False, ragged=False)
    del big
    # past the old caps (J, D <= 1024, context <= 8): a decoder and joiner
    # GREEDY_WIDE wide with GREEDY_WIDE_CTX tokens of context, from seed 0
    wdec, wjoin, wcfg = _wide_search_models(enc_dim)
    for dtype in (None, bf16):
        run(f"wide-{GREEDY_WIDE}-ctx{GREEDY_WIDE_CTX}", dtype, wdec, wcfg, wjoin,
            lambda t, dtype: frames(t, dtype, wjoin), GREEDY_T, False, 1, False)
    del wdec, wjoin
    torch.cuda.empty_cache()

    def pick(case, dtype):
        return next(r for r in rows if r["case"] == case and r["dtype"] == dtype)

    log("[3c] rnnt_greedy, this run: " + "; ".join(
        f"{what} {r['ms']:.4f} ms (device {r['device_ms']:.4f}), {r['bound_ms'] / r['ms']:.2%} "
        f"of its bound {r['bound_ms']:.5f} ({r['bound_by']})"
        for what, r in (("offline bf16", pick("offline", "bfloat16")),
                        ("float32", pick("offline", "float32")),
                        ("streaming step", pick("streaming", "bfloat16")),
                        ("offline 1 in 6", pick("offline-1in6", "bfloat16")),
                        ("offline V=5500", pick("offline-v5500", "bfloat16"))))
        + f" | {GREEDY_ONE_BLOCK}")
    return rows, plans


# [3d] the beam search kernel (rnnt_beam): BEAM_K beams per lane at the
# offline and streaming main paths' shapes, also at BEAM_WIDE_K beams, with
# one frame in six emitting, at GREEDY_BIG_VOCAB (the weights streamed), with
# 15 lanes beside the 16 (one wave either way), with ragged lanes in an order
# that the kernel pairs by length, and at a vocabulary of BEAM_SMALL_V
# under extra_skip_sos (allowed columns {blank, 3, 4}: fewer than BEAM_K, so
# the forbidden ones enter the top K)
BEAM_WIDE_K = 8
BEAM_MAX_TOKENS = 1024  # OfflineRecognizer's default buffer
BEAM_FIELDS = ("hyp", "tokens", "timestamps", "count")
BEAM_SMALL_V, BEAM_SMALL_V_T = 5, 200
# the kernel of one cluster per lane that this design replaced, at the same
# cases (PERF.md §6, NVIDIA H100 80GB HBM3 at 700.00 W)
BEAM_REPLACED = ("offline bf16 26.37 ms (device 25.82), float32 50.54 (50.01), streaming "
                 "step 0.396 (0.292), one frame in six 20.51 (20.15), K=8 46.26 (45.77), "
                 "V=5,500 91.33 (91.13)")


def _beam_bytes_ops(ops, b, k, u, frames, emits):
    """The least bytes and operations of one beam search, counted from what
    this run's data needs: the valid frames of enc_proj read once, the two
    weights and biases once, the context-table rows the emitting beams
    gather (at most the whole tables), the beams' state read and written
    once (contexts, decoder outputs, scores, counts, the token and timestamp
    buffers), the lanes' lengths and offsets read; K joiner rows per valid
    frame (2 K J V) and a decoder refresh per emitting beam (2 D J)."""
    c, v, d = ops.tables.shape
    j = ops.joiner_dim
    e = 4 if ops.compute_dtype is None else 2
    weights = (j * v + d * j) * e + (j + v) * 4
    tables = min(c * v * d, emits * c * d) * 4
    state = b * k * (c * 8 + j * e + 4 + 8 + 2 * u * 8)
    nbytes = frames * j * e + weights + tables + 2 * state + 2 * b * 8
    return nbytes, 2 * frames * k * j * v + 2 * emits * d * j


def _beam_plans(cases) -> dict:
    """[3d]'s first line: each case's launch shape (rnnt_beam.kernel_lanes:
    the lanes a cluster, P, that the wrapper chooses, the clusters, the
    clusters at once at that P and the waves) and its plan on this card
    (rnnt_beam.kernel_plan at P), held equal to the host mirror
    (rnnt_beam.plan_bytes), and the registers and spills.  Returns the plans
    by case."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    plans, parts = {}, []
    for name, dtype, j, d, v, c, k, b in cases:
        shape = rnnt_beam.kernel_lanes(b, j, d, v, c, k, dtype)
        p = rnnt_beam.kernel_plan(j, d, v, c, k, dtype, shape["lanes"])
        mirror = rnnt_beam.plan_bytes(j, d, v, c, k, dtype, limit=limit, lanes=shape["lanes"])
        if (p["smem_bytes"], p["resident_ntiles"], p["resident_chunks"]) != (
                mirror["smem_bytes"], mirror["res_w"], mirror["res_d"]):
            raise AssertionError(f"rnnt_beam plan {name}: card {p} vs host mirror {mirror}")
        dt = "float32" if dtype is None else "bf16"
        plans[f"{name} {dt}"] = dict(p, **shape)
        parts.append(f"{name} {dt} (B={b} K={k} J={j} D={d} V={v}): P={shape['lanes']} "
                     f"({shape['clusters']} clusters, {shape['clusters_at_once']} at once, "
                     f"{shape['waves']} wave(s)), {p['smem_bytes']} B/block, W_out "
                     f"{p['resident_ntiles']}/{p['ntiles_per_rank']} n-tiles resident, "
                     f"decoder_proj {p['resident_chunks']}/{p['chunks_per_rank']} chunks, "
                     f"rings of {p['ring_stages']}")
    log(f"[3d] rnnt_beam: clusters of {rnnt_greedy.CLUSTER} blocks x 512 threads, P lanes each "
        f"| " + " | ".join(parts) + f" | host mirror equal | ptxas -v: {_ptxas('rnnt_beam_kernel')}")
    return plans


def _small_vocab_models(enc_dim):
    """A decoder and joiner of Zipformer2Config's widths (512) with a
    vocabulary of BEAM_SMALL_V and context 2, from numpy seed 0, on the
    card."""
    rng = np.random.default_rng(0)
    cfg = DecoderConfig(vocab_size=BEAM_SMALL_V, decoder_dim=512, context_size=2)
    dec = decoder_mod.init_params(rng, cfg)
    join = joiner_mod.init_params(rng, joiner_mod.JoinerConfig(enc_dim, 512, 512, BEAM_SMALL_V))
    return params_from_numpy(dec, "cuda"), params_from_numpy(join, "cuda"), cfg


def _paired_lens(b, t):
    """Ragged lanes (``_greedy_lens``) in an order that puts a long lane
    beside a short one: 0, b-1, 1, b-2, ..."""
    order = [i // 2 if i % 2 == 0 else b - 1 - i // 2 for i in range(b)]
    return _greedy_lens(b, t)[torch.tensor(order, device="cuda")]


def _beam_compare(case, dtype, dec, cfg, join, st, enc, lens, offset, sos, got, trace, window):
    """The kernel's state ``got`` and ``trace`` against the plain version
    from ``st``.  float32: in each lane every field but the scores and
    decoder outputs exactly, and each frame's recorded choice exactly; the
    scores (and the recorded ones) to atol 1e-4 + rtol 1e-5, the decoder
    outputs to F32_ATOL (summation order: the kernel's log-sum-exp is merged
    over the ranks, its blank sums are sequential, the plain version's a
    cumsum).  A lane whose two searches part at a near-tie (two candidates
    within a float32 ulp of a score of thousands: the order of a sum decides
    them) is held instead, with every other lane, by the beam replay at
    BEAM_F32_ULPS, and the frame where it parted and the two choices' gap are
    printed.  bf16: the beam replay at BEAM_ULPS.  Returns (max abs score
    error of the lanes held exactly, steps decided otherwise than the plain
    top K in bf16 / lanes parted at a near-tie in float32)."""
    def fail(detail):
        raise AssertionError(f"rnnt_beam {case}: kernel disagrees with plain ({detail})")

    b = len(lens)
    if dtype is None:
        plain = rnnt_beam.BeamTrace.empty(*trace.steps.shape, "cuda")
        want = rnnt_beam.beam_frames_skip_reference(dec, cfg, join, st, enc, lens, offset, sos,
                                                    dtype, window, plain)
        valid = torch.arange(enc.shape[1], device="cuda")[None, :] < lens[:, None]
        same = ((trace.steps == plain.steps).all(2) | ~valid).all(1)
        for f in BEAM_FIELDS:
            same &= (getattr(got, f) == getattr(want, f)).reshape(b, -1).all(1)
        score_ok = torch.isclose(got.score, want.score, atol=1e-4, rtol=1e-5).all(1)
        recorded_ok = (torch.isclose(trace.values, plain.values, atol=1e-4, rtol=1e-5).all(2)
                       | ~valid).all(1)
        if not bool((score_ok & recorded_ok)[same].all()):
            fail("scores beyond atol 1e-4 + rtol 1e-5")
        err = float((got.dec_proj - want.dec_proj).abs()[same].max()) if bool(same.any()) else 0.0
        if err > F32_ATOL:
            fail(f"dec_proj max abs error {err}")
        parted = (~same).nonzero()[:, 0].tolist()
        if parted:
            res = beam_replay(dec, cfg, join, st, enc, lens, offset, got, trace, sos, dtype,
                              BEAM_F32_ULPS, window)
            if not res.ok:
                fail(f"lanes {parted} parted from the plain version, and the float32 beam "
                     f"replay refuses: {res.reason}")
            for lane in parted:
                f = int(((trace.steps[lane] != plain.steps[lane]).any(1)
                         & valid[lane]).nonzero()[0, 0])
                kv, pv = trace.values[lane, f], plain.values[lane, f]
                ulp = torch.finfo(torch.float32).eps * torch.exp2(torch.floor(torch.log2(
                    pv.abs().max())))
                log(f"[3d] rnnt_beam {case}: lane {lane} parted from the plain version at frame "
                    f"{f} of {int(lens[lane])}: its K new beams' scores differ from the plain "
                    f"ones by at most {float((kv - pv).abs().max() / ulp):.1f} float32 ulps "
                    f"(|score| {float(pv.abs().max()):.1f}); the float32 beam replay at "
                    f"{BEAM_F32_ULPS:g} ulps accepts the whole search")
        score_err = (float((got.score - want.score).abs()[same].max()) if bool(same.any())
                     else 0.0)
        return score_err, len(parted)
    res = beam_replay(dec, cfg, join, st, enc, lens, offset, got, trace, sos, dtype, BEAM_ULPS,
                      window)
    if not res.ok:
        fail(f"beam replay: {res.reason}")
    return 0.0, res.differing


def phase_beam(bw):
    """[3d] rnnt_beam against its plain version at the main paths' shapes, on
    the decoder and joiner of Zipformer2Config(causal=True) from seed 0
    (vocab 500, decoder and joiner 512 wide, context 2) and random encoder
    frames through its encoder projection: offline, 16 lanes x GREEDY_T
    frames from frame 0 at BEAM_K beams in both dtypes (the main path's
    batch, the headline) and 15 lanes in bf16; streaming, 16 lanes x one
    window's encoder frames, frame_offset per lane, extra_skip_sos,
    GREEDY_STEPS steps chained; in bf16 offline with the blank bias raised
    until about GREEDY_RATE of the greedy search's frames emit, at
    BEAM_WIDE_K beams, at a GREEDY_BIG_VOCAB vocabulary (its weights
    stream) and with ragged lanes (``_paired_lens``); and in float32 at a
    BEAM_SMALL_V vocabulary under extra_skip_sos, where the forbidden
    columns enter the top K.  Each case prints its P, clusters, clusters at
    once and waves, the microseconds per frame of a cluster (device time
    over waves x the longest lane's frames) and the emission steps that took
    the kernel's second exchange.  The plain version runs once per case (it
    syncs once per trip).  Returns (rows, plans)."""
    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=True), vocab_size=500,
                                seed=0, device="cuda")
    dec, join, cfg = bundle.decoder, bundle.joiner, bundle.decoder_cfg
    chunk = get_encoder("zipformer2").output_chunk_len(bundle.encoder_cfg)
    enc_dim = join["encoder_proj"]["w"].shape[0]
    j_dim, d_dim = join["decoder_proj"]["w"].shape[1], join["decoder_proj"]["w"].shape[0]
    b, bf16 = FLAGSHIP_B, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    plans = _beam_plans([("flagship", dt, j_dim, d_dim, 500, 2, BEAM_K, b) for dt in (None, bf16)]
                        + [("15-lanes", bf16, j_dim, d_dim, 500, 2, BEAM_K, b - 1),
                           (f"K{BEAM_WIDE_K}", bf16, j_dim, d_dim, 500, 2, BEAM_WIDE_K, b),
                           ("vocab-5500", bf16, j_dim, d_dim, GREEDY_BIG_VOCAB, 2, BEAM_K, b),
                           (f"vocab-{BEAM_SMALL_V}", None, j_dim, d_dim, BEAM_SMALL_V, 2, BEAM_K,
                            b)])

    def frames(t, dtype, joiner=join, lanes=b):
        x = torch.randn((lanes, t, enc_dim), generator=g, device="cuda")
        with torch.inference_mode():
            return joiner_mod.project_encoder(joiner, x, dtype)

    def run(case, dtype, k, dec, cfg, join, make, t, sos, steps, lanes=b, lens_of=None):
        ops = rnnt_greedy.greedy_operands(dec, cfg, join, dtype)
        st = rnnt_beam.init_state(dec, cfg, join, lanes, k, BEAM_MAX_TOKENS, dtype)
        offset = (torch.arange(lanes, device="cuda") * 997) if steps > 1 else torch.zeros(
            lanes, dtype=torch.int64, device="cuda")
        worst, differing, emits, lane_frames, second, emit_steps = 0.0, 0, 0, 0, 0, 0
        for step in range(steps):
            enc = make(t, dtype, join, lanes)
            lens = torch.full((lanes,), t, device="cuda") if lens_of is None else lens_of(lanes, t)
            if steps > 1:  # streaming: lanes that skip a step, or take part of a window
                lens = torch.roll(_greedy_lens(lanes, t), step)
            trace = rnnt_beam.BeamTrace.empty(lanes, t, k, "cuda")
            with exact_f32(), torch.inference_mode():
                got = rnnt_beam.beam_frames_skip(dec, cfg, join, st, enc, lens, offset, sos,
                                                 dtype, operands=ops, trace=trace)
                torch.cuda.synchronize()
                err, diff = _beam_compare(f"{case} step {step}", dtype, dec, cfg, join, st, enc,
                                          lens, offset, sos, got, trace, 64)
            parent, stored, kind, token = trace.fields()
            valid = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[..., None]
            emitting = valid & (kind == rnnt_beam.STEP_EMIT)
            emits += int((emitting & (token != cfg.blank_id)).sum())
            emit_steps += int(emitting[..., 0].sum())
            second += int(trace.second.sum())
            lane_frames += int(lens.clamp(max=t).sum())
            worst, differing = max(worst, err), differing + diff
            if case.startswith(f"offline-v{BEAM_SMALL_V}-"):
                forbidden = int((emitting & ((token == 1) | (token == 2))).sum())
                if not forbidden:
                    raise AssertionError(f"rnnt_beam {case}: no forbidden column entered the "
                                         f"top K")
                log(f"[3d] rnnt_beam {case}: {forbidden} new beams took a forbidden column "
                    f"(<sos/eos> or <unk>, at NEG_INF)")
            if step == steps - 1:
                def kernel(st=st, enc=enc, lens=lens, offset=offset):
                    return rnnt_beam.beam_frames_skip(dec, cfg, join, st, enc, lens, offset, sos,
                                                      dtype, operands=ops)

                def plain(st=st, enc=enc, lens=lens, offset=offset):
                    return rnnt_beam.beam_frames_skip_reference(dec, cfg, join, st, enc, lens,
                                                                offset, sos, dtype)

                last_frames = int(lens.clamp(max=t).sum())
                last_emits = int((valid & (kind == rnnt_beam.STEP_EMIT)
                                  & (token != cfg.blank_id)).sum())
                with exact_f32(), torch.inference_mode():
                    ms = cuda_ms(kernel, reps=5)
                    dev_ms = device_ms(kernel, reps=5)
                    plain_ms = cuda_ms(plain, reps=1, warm=0)
                peak_dtype = torch.float32 if dtype is None else dtype
                bound_ms, bound_by = bound(*_beam_bytes_ops(ops, lanes, k, BEAM_MAX_TOKENS,
                                                            last_frames, last_emits),
                                           peak_dtype, bw)
                c_, v_, d_ = ops.tables.shape
                shape = rnnt_beam.kernel_lanes(lanes, ops.joiner_dim, d_, v_, c_, k, dtype)
                longest = int(lens.clamp(max=t).max())
                us_frame = dev_ms * 1e3 / (shape["waves"] * max(longest, 1))
                row = {"case": case, "dtype": str(peak_dtype).split(".")[-1], "B": lanes, "T": t,
                       "K": k, "J": ops.joiner_dim, "V": ops.vocab, "frames": last_frames,
                       "emitting_beams": last_emits, "max_abs_err": worst,
                       "differing_steps": differing, "ms": ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "lanes_per_cluster": shape["lanes"], "clusters": shape["clusters"],
                       "clusters_at_once": shape["clusters_at_once"], "waves": shape["waves"],
                       "us_per_cluster_frame": us_frame, "emission_steps": emit_steps,
                       "second_exchange_steps": second}
                rows.append(row)
                log(f"[3d] rnnt_beam {case:16s} {row['dtype']:8s} B={lanes} T={t} K={k} "
                    f"J={row['J']} V={row['V']}: {lane_frames} lane-frames, {emits} emitting "
                    f"beam-steps in {steps} call(s), "
                    + (f"every field equal, max score err {worst:.2e}" if dtype is None else
                       f"replay ok at {BEAM_ULPS:g} ulps, {differing} steps decided otherwise "
                       f"than the plain top K")
                    + (f", {differing} lane(s) parted at a near-tie" if dtype is None and
                       differing else "")
                    + f" | P={shape['lanes']}, {shape['clusters']} clusters, "
                    f"{shape['clusters_at_once']} at once, {shape['waves']} wave(s), "
                    f"{us_frame:.2f} us per frame of a cluster | second exchange on {second} of "
                    f"{emit_steps} emission steps ({second / max(emit_steps, 1):.3%}; "
                    f"{second / max(lane_frames, 1):.3%} of lane-frames)"
                    + f" | kernel {ms:.4f} ms (device {dev_ms:.4f}) | plain {plain_ms:.2f} ms "
                    f"| bound {bound_ms:.5f} ms ({bound_by}) | {bound_ms / ms:.2%} of bound "
                    f"({bound_ms / dev_ms:.2%} of device time)")
            st, offset = got, offset + lens

    for dtype in (None, bf16):
        run("offline", dtype, BEAM_K, dec, cfg, join, frames, GREEDY_T, False, 1)
    run("offline-15lanes", bf16, BEAM_K, dec, cfg, join, frames, GREEDY_T, False, 1, lanes=b - 1)
    run("streaming", bf16, BEAM_K, dec, cfg, join, frames, chunk, True, GREEDY_STEPS)
    full = torch.full((b,), GREEDY_T, device="cuda")
    with torch.inference_mode():
        rate_join, bias, rate = _joiner_at_rate(dec, cfg, join, frames(GREEDY_T, bf16), full,
                                                bf16, GREEDY_RATE)
    log(f"[3d] rnnt_beam offline-1in6: blank bias +{bias:.4f} (the greedy search emits "
        f"{rate:.4f} per frame)")
    run("offline-1in6", bf16, BEAM_K, dec, cfg, rate_join, frames, GREEDY_T, False, 1)
    run(f"offline-K{BEAM_WIDE_K}", bf16, BEAM_WIDE_K, dec, cfg, join, frames, GREEDY_T, False, 1)
    run("offline-ragged", bf16, BEAM_K, dec, cfg, join, frames, GREEDY_T, False, 1,
        lens_of=_paired_lens)
    lens = _paired_lens(b, GREEDY_T).tolist()
    by_len = sorted(lens, reverse=True)
    pairs = rnnt_beam.kernel_lanes(b, j_dim, d_dim, 500, 2, BEAM_K, bf16)["lanes"]
    log(f"[3d] rnnt_beam offline-ragged: lanes of {min(lens)}-{max(lens)} frames; with P={pairs} "
        f"the clusters run {sum(max(by_len[i:i + pairs]) for i in range(0, b, pairs))} frames "
        f"in all paired by length (the kernel ranks the lanes), "
        f"{sum(max(lens[i:i + pairs]) for i in range(0, b, pairs))} in the caller's order")
    sdec, sjoin, scfg = _small_vocab_models(enc_dim)
    run(f"offline-v{BEAM_SMALL_V}-sos", None, BEAM_K, sdec, scfg, sjoin, frames, BEAM_SMALL_V_T,
        True, 1)
    del sdec, sjoin, bundle
    big = ModelBundle.random("zipformer2", Zipformer2Config(causal=True),
                             vocab_size=GREEDY_BIG_VOCAB, seed=0, device="cuda")
    run("offline-v5500", bf16, BEAM_K, big.decoder, big.decoder_cfg, big.joiner, frames,
        GREEDY_T, False, 1)
    del big
    torch.cuda.empty_cache()

    def pick(case):
        return next(r for r in rows if r["case"] == case and r["dtype"] == "bfloat16")

    one, fifteen = pick("offline"), pick("offline-15lanes")
    if one["waves"] != 1:
        raise AssertionError(f"rnnt_beam: {b} lanes at K={BEAM_K} take {one['waves']} waves")
    log(f"[3d] rnnt_beam one wave: {b} lanes at P={one['lanes_per_cluster']} "
        f"({one['clusters']} clusters) {one['device_ms']:.4f} ms of device time, {b - 1} lanes "
        f"at P={fifteen['lanes_per_cluster']} ({fifteen['clusters']} clusters) "
        f"{fifteen['device_ms']:.4f}; the replaced kernel (PERF.md §6): {BEAM_REPLACED}")
    return rows, plans


def greedy_replay(name, rec, enc, lens):
    """An offline main path's greedy search on one batch's encoder output
    (bf16), held to the plain ops by the tie-aware replay (not part of any
    counted run)."""
    b, cd = rec.bundle, rec.compute_dtype
    with torch.inference_mode():
        proj = joiner_mod.project_encoder(b.joiner, enc, cd)
        st = rnnt_greedy.init_state(b.decoder, b.decoder_cfg, b.joiner, enc.shape[0],
                                    rec.max_tokens, cd)
        zero = torch.zeros((enc.shape[0],), dtype=torch.int64, device="cuda")
        got = rnnt_greedy.greedy_frames_skip(b.decoder, b.decoder_cfg, b.joiner, st, proj, lens,
                                             zero, False, cd, operands=rec._search_ops)
        res = tie_aware_replay(b.decoder, b.decoder_cfg, b.joiner, st, proj, lens, zero, got,
                               False, cd, GREEDY_ULPS)
    log(f"[6] {name} greedy search on one batch vs the plain ops: tie-aware replay "
        f"{'ok' if res.ok else 'FAILED'} at {GREEDY_ULPS:g} ulps over {res.frames} frames, "
        f"{res.differing} decided otherwise than the plain argmax (worst {res.worst_ulps:.2f} "
        f"ulps)")
    if not res.ok:
        raise AssertionError(f"rnnt_greedy {name}: kernel disagrees with plain ({res.reason})")
    return res


BEAM_ULPS = 2.0  # bf16: the beam replay's band (testing.py::beam_replay)
# float32: the replay's band for a lane parted at a near-tie (float32 ulps
# of the logits; the band's 4 ulps of the scores come on top)
BEAM_F32_ULPS = 4.0


@contextlib.contextmanager
def beam_capture():
    """Within: every call of rnnt_beam.beam_frames_skip (the recognizers look
    it up at each call) records its choices in a BeamTrace, and its inputs,
    result and trace are kept in the yielded list for beam_replays.  The
    launches still count on the kernel's wrapper."""
    calls = []
    launch = rnnt_beam.beam_frames_skip

    def recorded(dec, cfg, join, state, enc_proj, enc_lens, offset, sos=False, cd=None,
                 window=64, operands=None, trace=None):
        b, t = enc_proj.shape[:2]
        trace = rnnt_beam.BeamTrace.empty(b, t, state.score.shape[1], enc_proj.device)
        out = launch(dec, cfg, join, state, enc_proj, enc_lens, offset, sos, cd, window,
                     operands=operands, trace=trace)
        # copies: an online step then writes its result into the lane pool,
        # which holds the state and the frame offsets it was given
        calls.append((tree_map(torch.clone, state), enc_proj, enc_lens, offset.clone(), sos, cd,
                      window, out, trace))
        return out

    # the wrapper counts its launches on its own attributes, looked up by
    # name at each call: the stand-in shares them
    recorded.__dict__ = launch.__dict__
    rnnt_beam.beam_frames_skip = recorded
    try:
        yield calls
    finally:
        rnnt_beam.beam_frames_skip = launch


def beam_replays(tag, name, rec, calls):
    """Each captured beam search of a recognizer's run held to the plain ops
    by the beam replay (bf16; float32 searches against the plain version
    itself in [3d])."""
    b = rec.bundle
    frames = differing = 0
    worst = 0.0
    with torch.inference_mode():
        for i, (st, proj, lens, offset, sos, cd, window, out, trace) in enumerate(calls):
            res = beam_replay(b.decoder, b.decoder_cfg, b.joiner, st, proj, lens, offset, out,
                              trace, sos, cd, BEAM_ULPS, window)
            if not res.ok:
                raise AssertionError(f"rnnt_beam {name} search {i}: kernel disagrees with plain "
                                     f"({res.reason})")
            frames, differing, worst = frames + res.frames, differing + res.differing, max(
                worst, res.worst_ulps)
    log(f"{tag} {name} beam searches vs the plain ops: beam replay ok at {BEAM_ULPS:g} ulps "
        f"for all {len(calls)} searches ({frames} lane-frames, {differing} steps decided "
        f"otherwise than the plain top K, worst overshoot {worst:.2f} bands)")


def eager_begin(rec, streams):
    """begin_decode as it was before the program: the upload and eager
    _decode, each op launched from Python, and no readback started (the
    handle's host buffers are the device tensors, which end_decode copies
    back when it reads them, behind whatever the stream holds by then)."""
    samples, counts = rec.pcm_batch(streams)
    with torch.inference_mode():
        out = rec._decode(samples, counts)
    return PendingDecode(streams, out, None)


@contextlib.contextmanager
def graph_audit():
    """Within: every DecodeProgram call must run a captured graph (a replay;
    the first call of a shape captures first), and what it made is held bit
    for bit against eager ``fn`` on the same inputs (under the call's own
    inference mode and precision; the eager run's launches are not
    counted): offline the outputs of ``_decode``; online, where ``fn`` is
    the step that writes the lane pool in place, every pool leaf after the
    replay against the eager step run from the pool as it was before.
    Yields a list with one (key, captured here) per call."""
    calls = []
    call = DecodeProgram.__call__

    def audited(self, samples, counts):
        key = tuple(samples.shape)
        new = key not in self.entries
        rec = getattr(self.fn, "__self__", None)
        online = isinstance(rec, OnlineRecognizer)
        start = [t.clone() for t in pool_leaves(rec)] if online else None
        out = call(self, samples, counts)
        if self.entries[key].graph is None:
            raise AssertionError(f"program {key}: no graph on the card")
        saved = read_counts()
        if online:
            out = tuple(t.clone() for t in pool_leaves(rec))
            for t, t0 in zip(pool_leaves(rec), start):
                t.copy_(t0)
        eager = self.fn(samples.to(self.device), counts.to(self.device))
        if online:
            eager = tuple(pool_leaves(rec))
        for name, fn in KERNELS.items():
            fn.launches = saved[name]
        if len(out) != len(eager) or not all(
                g.dtype == e.dtype and torch.equal(g, e) for g, e in zip(out, eager)):
            raise AssertionError(f"program {key}: what the graph made differs from eager "
                                 f"{'step' if online else '_decode'}'s")
        calls.append((key, new))
        return () if online else out

    DecodeProgram.__call__ = audited
    try:
        yield calls
    finally:
        DecodeProgram.__call__ = call


@contextlib.contextmanager
def graph_dump():
    """Within: every graph a DecodeProgram captures is kept as a
    ``cudaGraph_t`` in debug mode (``keep_graph=True``), so that
    graph_kernel_nodes can dump it; yields the list of them.  Only for a
    capture whose nodes are counted: a recognizer's own graphs, the ones
    the timed batches replay, are captured as in production."""
    graphs = []
    capture = CudaGraphs.capture

    def kept(self, fn, inputs):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            outputs = fn(*inputs)
        graphs.append(graph)
        return graph, outputs

    CudaGraphs.capture = kept
    try:
        yield graphs
    finally:
        CudaGraphs.capture = capture


def graph_kernel_nodes(graph) -> tuple[dict, int]:
    """A captured graph's kernel nodes named after each of KERNELS (a node
    whose kernel's name holds it), and all its nodes, from
    cudaGraphDebugDotPrint's file (one record per node).  The graph must
    have been captured under graph_dump."""
    import warnings

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # PyTorch warns that debug_dump runs
            graph.debug_dump(path)
        with open(path) as f:
            nodes = re.split(r'\n(?="graph_\d+_node_\d+"\[)', f.read())[1:]
    return {name: sum(name in n for n in nodes) for name in KERNELS}, len(nodes)


def _swoosh_cases() -> list:
    """bias_swoosh's calls in one longform batch (20 x 30 s of
    Zipformer2Config(): 1496 encoder-rate frames at stack 0) and in one
    offpeak step (820 lanes x one window of Zipformer2Config(causal=True)),
    each shape once with its count: (name, shape, layout, in dtype, kind,
    calls per batch, calls per step).  Layouts as the encoder hands them
    over: a product's rows; a depthwise convolution's [B, C, T] seen as
    [B, T, C] (the non-causal conv modules; the causal ones' sum taken to
    lie likewise); the embed convs channels last, as cuDNN keeps an NHWC
    input's layout."""
    bf, f32 = torch.bfloat16, torch.float32
    cfg, b = Zipformer2Config(), SWOOSH_LONGFORM_B
    t0 = cfg.embed_len(SWOOSH_LONGFORM_FRAMES)
    c1, c2, c3 = cfg.embed_channels
    cases = []
    for route, lanes, frames, t_stage, count in (
            ("", b, t0, t0, "layers"), ("stream-", SWOOSH_STREAM_LANES, cfg.chunk_size,
                                        cfg.chunk_size, "stream_layers")):
        raw = SWOOSH_LONGFORM_FRAMES if not route else cfg.chunk_input_len
        f1 = cfg.feature_dim
        h2, f2 = (raw - 2 - 3) // 2 + 1, (f1 - 3) // 2 + 1
        embed = [(f"{route}embed-conv1", (lanes, raw - 2, f1, c1), "rows", f32, "r", 1),
                 (f"{route}embed-conv2", (lanes, h2, f2, c2), "rows", f32, "r", 1),
                 (f"{route}embed-conv3", (lanes, h2 - 2, cfg.embed_freq_out, c3), "rows", f32,
                  "r", 1),
                 (f"{route}convnext-pw1", (lanes, t_stage, cfg.embed_freq_out, 3 * c3), "rows",
                  bf, "l", 1)]
        for name, shape, layout, dtype, kind, n in embed:
            cases.append((name, shape, layout, dtype, kind, *((n, 0) if not route else (0, n))))
        for si in range(cfg.num_stacks):
            t = -(-frames // cfg.downsampling_factors[si])
            n = cfg.num_encoder_layers[si]
            ff = (f"{route}ff-stack{si}", (lanes * t, cfg.feedforward_dims[si]), "rows", bf, "l",
                  3 * n)
            conv = (f"{route}conv-stack{si}", (lanes, t, cfg.encoder_dims[si]), "depthwise", f32,
                    "r", 2 * n)
            for name, shape, layout, dtype, kind, k in (ff, conv):
                cases.append((name, shape, layout, dtype, kind, *((k, 0) if not route else (0, k))))
    return cases


def _swoosh_input(shape, layout, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    flat = (torch.randn(n, generator=g, device="cuda") * 5).to(dtype)
    if layout == "rows":
        return flat.view(shape)
    b, t, c = shape  # a depthwise convolution's [B, C, T]
    return flat.view(b, c, t).transpose(1, 2)


def phase_swoosh(bw):
    """bias_swoosh against its plain version at every shape of a longform
    batch and an offpeak step (``_swoosh_cases``), bf16 out: one bf16 ulp
    (the same float32 steps on both sides).  Each case's time (kernel,
    device, plain) beside its bound: (y's bytes + out's + the bias's) /
    bandwidth.  No PyTorch call computes a Swoosh (library: none)."""
    rows = []
    worst = 0.0
    for name, shape, layout, dtype, kind, layers, stream_layers in _swoosh_cases():
        y = _swoosh_input(shape, layout, dtype, seed=len(rows))
        bias = torch.randn(shape[-1], device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(len(rows)))
        out = ACT.bias_swoosh(y, bias, kind, torch.bfloat16)
        ref = ACT.bias_swoosh_reference(y, bias, kind, torch.bfloat16)
        torch.cuda.synchronize()
        err, ok = _max_err(out, ref, torch.bfloat16)
        if not ok:
            raise AssertionError(f"bias_swoosh {name}: kernel disagrees with plain (max {err})")
        worst = max(worst, err)
        differ = int((out != ref).sum())
        del out, ref

        def kernel():
            return ACT.bias_swoosh(y, bias, kind, torch.bfloat16)

        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, reps=20)
        host = host_us(kernel)
        plain_ms = cuda_ms(lambda: ACT.bias_swoosh_reference(y, bias, kind, torch.bfloat16),
                           reps=5, warm=1)
        n = y.numel()
        nbytes = n * (y.element_size() + 2) + 4 * shape[-1]
        bound_ms, bound_by = bound(nbytes, 0, torch.float32, bw)
        rows.append({"case": name, "family": "zipformer2", "dtype": "bfloat16",
                     "shape": list(shape), "layout": layout,
                     "in_dtype": str(dtype).split(".")[-1], "kind": kind, "layers": layers,
                     "stream_layers": stream_layers, "max_abs_err": err,
                     "elements_not_equal": differ, "ms": ms, "device_ms": dev_ms,
                     "host_us": host, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "library_device_ms": None})
        log(f"[3e] bias_swoosh {name:20s} {str(tuple(shape)):22s} {layout:9s} "
            f"{rows[-1]['in_dtype']:8s}-> bf16 Swoosh{kind.upper()}: max_err {err:.3e} ok "
            f"({differ} of {n} elements not equal) | kernel {ms:.4f} ms (device {dev_ms:.4f}, "
            f"host {host:.1f} us) | plain {plain_ms:.4f} ms | bound {bound_ms:.4f} ms "
            f"({bound_by}) | {bound_ms / dev_ms:.1%} of bound by device time")
        del y, bias
        torch.cuda.empty_cache()
    return rows, worst


# [3f]: the benchmark cells' batch of 20 x 30 s (conf_offline_longform,
# z2_offline_longform) and z2_stream_offpeak's pool of 820 lanes
CONV_ROWS, CONV_LANES = 20, 820
TF32_PEAK = 495e12  # H100 SXM, dense TF32 on the tensor cores


@contextlib.contextmanager
def encoder_convs():
    """Record the convolutions other than depthwise ones run while the block
    runs: yields a dict from (conv, shapes, strides, arguments) to [conv, x,
    w, arguments, whether it ran through ``ops/layers.conv_tf32`` (its
    ``launches`` rose), calls], the first call's operands cloned as they
    lay.  Every convolution of the port goes through ``ops/layers._conv``."""
    seen: dict = {}
    real = L._conv

    def spy(conv, xc, wc, compute_dtype, groups, **kw):
        before = L.conv_tf32.launches
        y = real(conv, xc, wc, compute_dtype, groups=groups, **kw)
        if not 1 < groups == xc.shape[1]:
            kw = dict(kw, groups=groups)
            key = (conv.__name__, tuple(xc.shape), xc.stride(), tuple(wc.shape),
                   tuple(sorted(kw.items())))
            if key not in seen:
                seen[key] = [conv, xc.clone(), wc.clone(), kw, L.conv_tf32.launches != before, 0]
            seen[key][-1] += 1
        return y

    L._conv = spy
    try:
        yield seen
    finally:
        L._conv = real


def _conv_cases() -> list:
    """(cell, name, scoped, calls a replay, conv, x, w, arguments) of every
    convolution but the depthwise ones in one eager conformer and zipformer2
    longform batch and one eager offpeak step, at full width with random
    weights; ``scoped``: run through ``ops/layers.conv_tf32``."""
    n = 30 * 16000
    runs = []
    for family, cell in (("conformer", "conf_offline_longform"),
                         ("zipformer2", "z2_offline_longform")):
        bundle = ModelBundle.random(family, FAMILIES[family]["cfg"](), vocab_size=500, seed=0,
                                    device="cuda")
        rec = OfflineRecognizer(bundle, device="cuda")
        streams = streams_for(rec, [synth_pcm(n, i) for i in range(CONV_ROWS)])
        runs.append((cell, lambda rec=rec, streams=streams: rec.encode(*rec.pcm_batch(streams))))
    bundle = ModelBundle.random("zipformer2", Zipformer2Config(causal=True), vocab_size=500,
                                seed=0, device="cuda")
    rec = OnlineRecognizer(bundle, max_lanes=CONV_LANES, device="cuda")
    rec.program = None  # the eager step: one call of each convolution
    stream = rec.create_online_stream()
    stream.add_samples(synth_pcm(rec.window_samples, 0))
    runs.append(("z2_stream_offpeak", lambda: rec.get_results([stream])))
    cases = []
    for cell, run in runs:
        with encoder_convs() as seen:
            run()
        torch.cuda.synchronize()
        for k, (conv, x, w, kw, scoped, calls) in enumerate(seen.values()):
            what = (f"pointwise-{w.shape[1]}to{w.shape[0]}" if conv.__name__ == "conv1d"
                    else f"embed-conv{k + 1}")
            cases.append((cell, what, scoped, calls, conv, x, w, kw))
    del rec, runs
    gc.collect()
    torch.cuda.empty_cache()
    return cases


def phase_conv_tf32(bw):
    """Each convolution of the benchmark cells' encoders but the depthwise
    ones, at the cells' shapes and layouts (``_conv_cases``), run through
    ``ops/layers.conv_tf32`` (TF32 on the tensor cores) and on FFMA
    (``exact_f32``: true float32): the TF32 product of each one the port
    scopes held to the FFMA one within (K + 2) x 2^-23 x the conv of |x|
    and |w|, K = C_in/g x kh x kw (the float32 summation-order bound; the
    operands are bf16-rounded, so every product is exact in both); each
    one's device time both ways, beside its bound at 495 (TF32) and 67
    (FFMA) TFLOP/s and the bandwidth, and whether the port scopes it (the
    narrow embed conv1, 1 -> 8 channels, is the row behind
    ``TF32_MIN_OUT_CHANNELS``).  The process's flags stay off throughout:
    ``conv_tf32`` asks for TF32 in its own call."""
    rows = []
    for cell, what, scoped, calls, conv, x, w, kw in _conv_cases():
        k = int(np.prod(w.shape[1:]))
        if scoped != (w.shape[0] // kw.get("groups", 1) >= L.TF32_MIN_OUT_CHANNELS):
            raise AssertionError(f"[3f] {cell} {what}: scoped {scoped} against the rule")
        before = L.conv_tf32.launches
        got = L.conv_tf32(conv, x, w, **kw)
        if L.conv_tf32.launches != before + 1 or torch.backends.cudnn.allow_tf32:
            raise AssertionError(f"[3f] {cell} {what}: conv_tf32 left the flag on or did not "
                                 f"count")
        with exact_f32():
            want = conv(x, w, **kw)
            mag = conv(x.abs(), w.abs(), **kw)
        limit = (k + 2) * 2.0**-23 * mag
        err = (got - want).abs()
        worst = float((err / limit.clamp_min(torch.finfo(torch.float32).tiny)).max())
        if scoped and worst > 1:
            raise AssertionError(f"[3f] {cell} {what}: TF32 against FFMA past the float32 "
                                 f"summation bound (max err {err.max().item():.3e})")
        flops = 2 * got.numel() * k
        nbytes = 4 * (x.numel() + w.numel() + got.numel())
        del got, want, mag, limit, err
        tf32_ms = device_ms(lambda: L.conv_tf32(conv, x, w, **kw), reps=10)
        with exact_f32():
            ffma_ms = device_ms(lambda: conv(x, w, **kw), reps=10)
        tf32_bound = max(flops / TF32_PEAK, nbytes / bw) * 1e3
        ffma_bound = max(flops / peak_flops(torch.float32), nbytes / bw) * 1e3
        rows.append({"cell": cell, "conv": what, "scoped": scoped, "calls": calls,
                     "x": list(x.shape), "x_stride": list(x.stride()), "w": list(w.shape),
                     "args": repr(kw), "reduction": k, "gflop": flops / 1e9,
                     "gbytes": nbytes / 1e9, "tf32_device_ms": tf32_ms,
                     "ffma_device_ms": ffma_ms, "tf32_bound_ms": tf32_bound,
                     "ffma_bound_ms": ffma_bound, "err_over_limit": worst})
        log(f"[3f] conv {cell} {what} x{calls} ({'TF32' if scoped else 'FFMA: not scoped'}): "
            f"x {tuple(x.shape)} w {tuple(w.shape)} {kw}, K {k}, {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB | TF32 {tf32_ms:.3f} ms (bound {tf32_bound:.3f}, "
            f"{tf32_bound / tf32_ms:.1%}) | FFMA {ffma_ms:.3f} ms (bound {ffma_bound:.3f}) | "
            f"FFMA/TF32 {ffma_ms / tf32_ms:.2f}x | TF32 err {worst:.3g} of the bound")
        del x, w
        torch.cuda.empty_cache()
    return rows


def phase_golden(family):
    spec = FAMILIES[family]
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
    reset_counts()
    res = rec.get_result(streams_for(rec, [pin_pcm(6400)])[0])
    counts = read_counts()
    log(f"[4] {family} pin on card: {res.text!r} {res.timestamps} (launches {counts})")
    if res.text != spec["pin_text"] or res.timestamps != spec["pin_timestamps"]:
        raise AssertionError(f"{family} pin mismatch: {res.text!r} {res.timestamps}")
    return family_launches(f"{family}_pin_offline", spec, counts)


def phase_online_pin(family):
    """The online pin: the pin dir's bundle through OnlineRecognizer on the
    card, f32, decode_to_end (the tail flush included)."""
    spec = FAMILIES[family]
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    rec = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device="cuda")
    stream = rec.create_online_stream()
    stream.add_samples(pin_pcm(6400))
    reset_counts()
    res = rec.decode_to_end(stream)
    counts = read_counts()
    log(f"[4] {family} online pin on card: {res.text!r} {res.timestamps} (launches {counts})")
    if res.text != spec["online_pin_text"]:
        raise AssertionError(f"{family} online pin mismatch: {res.text!r}")
    return family_launches(f"{family}_pin_online", spec, counts)


def _nbest_pinned(results):
    return [(r.text, r.timestamps) for r in results]


def phase_beam_pins(family) -> dict:
    """modified_beam_search (K=4) on the pin dir's bundle on the card, f32:
    every n-best hypothesis must be BEAM_PINS', offline (get_nbest_results)
    and online (decode_to_end, then get_nbest_results).  Returns each run's
    launches of the family's kernel."""
    spec = FAMILIES[family]
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, f"{family}_pin"), device="cuda")
    kw = dict(decoding_method=BEAM, compute_dtype=None, max_active_paths=BEAM_K, device="cuda")
    launches = {}
    rec = OfflineRecognizer(bundle, **kw)
    reset_counts()
    got = _nbest_pinned(rec.get_nbest_results(streams_for(rec, [pin_pcm(6400)]))[0])
    log(f"[4] {family} beam pin on card (K={BEAM_K}): {got} (launches {read_counts()})")
    launches["pin_beam_offline"] = family_launches(f"{family}_pin_beam_offline", spec,
                                                   read_counts(), BEAM)
    if got != BEAM_PINS[family]["offline"]:
        raise AssertionError(f"{family} offline beam pin mismatch: {got}")
    rec = OnlineRecognizer(bundle, max_lanes=2, **kw)
    stream = rec.create_online_stream()
    stream.add_samples(pin_pcm(6400))
    reset_counts()
    rec.decode_to_end(stream)
    got = _nbest_pinned(rec.get_nbest_results([stream])[0])
    log(f"[4] {family} online beam pin on card: {got} (launches {read_counts()})")
    launches["pin_beam_online"] = family_launches(f"{family}_pin_beam_online", spec,
                                                  read_counts(), BEAM)
    if got != BEAM_PINS[family]["online"]:
        raise AssertionError(f"{family} online beam pin mismatch: {got}")
    return launches


def phase_beam_full_width_vs_cpu(family="zipformer2"):
    """Offline modified_beam_search (K=4) at full width from a seed, one 5 s
    utterance, f32: card against CPU, the best beam's tokens and timestamps
    identical and its score within 1e-3 relative; how many of the K n-best
    hypotheses agree exactly is printed."""
    cfg = FAMILIES[family]["cfg"]()
    pcm = [synth_pcm(5 * 16000, 101)]
    outs = {}
    for dev in ("cuda", "cpu"):
        bundle = ModelBundle.random(family, cfg, vocab_size=500, seed=0, device=dev)
        rec = OfflineRecognizer(bundle, decoding_method=BEAM, compute_dtype=None,
                                max_active_paths=BEAM_K, device=dev)
        t0 = time.time()
        streams = streams_for(rec, pcm)
        reset_counts()
        pending = rec.begin_decode(streams)
        best = rec.end_decode(pending)[0]
        outs[dev] = (best, rec._nbest_results(streams, pending.host)[0],
                     float(pending.host[3][0, 0]))
        if dev == "cuda":
            family_launches(f"{family}_card_vs_cpu_beam", FAMILIES[family], read_counts(), BEAM)
        log(f"[5] {family} beam full width f32 on {dev}: {len(outs[dev][0].tokens)} tokens, "
            f"best score {outs[dev][2]:.4f}, {time.time() - t0:.1f} s")
    (rg, ng, sg), (rc, nc, sc) = outs["cuda"], outs["cpu"]
    same = sum((a.tokens, a.timestamps) == (b.tokens, b.timestamps) for a, b in zip(ng, nc))
    log(f"[5] {family} beam card vs CPU: best tokens identical {rg.tokens == rc.tokens}, "
        f"score rel diff {abs(sg - sc) / abs(sc):.2e}; {same} of {BEAM_K} n-best identical")
    if rg.tokens != rc.tokens or rg.timestamps != rc.timestamps:
        raise AssertionError(f"{family}: best beam differs between card and CPU")
    if abs(sg - sc) > 1e-3 * abs(sc):
        raise AssertionError(f"{family}: best beam score {sg} vs {sc} beyond 1e-3 relative")


def stream_encoder_outputs(rec, pcm):
    """Each window's encoder output for one stream, f32: the recognizer's
    windows (tail flush included), int16 samples and fbank tables, stepped
    through the family's streaming_step."""
    b = rec.bundle
    stream = rec.create_online_stream()
    stream.add_samples(pcm)
    stream.input_finished()
    state = rec._enc.init_state(b.encoder_cfg, 1, rec.device)
    outs = []
    with torch.inference_mode(), exact_f32():
        while stream._ready():
            w = np.clip(stream._take_window() * 32768.0, -32768, 32767).astype(np.int16)
            x = torch.from_numpy(w).to(rec.device)[None].float() * (1.0 / 32768.0)
            feats = fbank_compute(x, b.frontend_cfg, b.encoder_cfg.chunk_input_len,
                                  tables=rec._fbank_tables)
            out, state = rec._enc.streaming_step(rec.encoder, b.encoder_cfg, state, feats, None)
            outs.append(out.cpu())
    rec.dispose_stream(stream)
    return outs


def phase_streaming_vs_cpu(family):
    """The streaming path at full width (the causal flagship config), one
    5 s stream from a seed, f32: card (kernel) against CPU (plain), each
    step's encoder output and the final tokens and timestamps."""
    cfg = FAMILIES[family]["stream_cfg"]()
    pcm = synth_pcm(5 * 16000, 202)
    outs = {}
    for dev in ("cuda", "cpu"):
        bundle = ModelBundle.random(family, cfg, vocab_size=500, seed=0, device=dev)
        rec = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=2, device=dev)
        t0 = time.time()
        steps = stream_encoder_outputs(rec, pcm)
        stream = rec.create_online_stream()
        stream.add_samples(pcm)
        reset_counts()
        res = rec.decode_to_end(stream)
        if dev == "cuda":
            family_launches(f"{family}_card_vs_cpu_streaming", FAMILIES[family], read_counts())
        outs[dev] = (steps, res)
        log(f"[5] {family} streaming full width f32 on {dev}: {len(steps)} steps of "
            f"{tuple(steps[0].shape)}, {len(res.tokens)} tokens, {time.time() - t0:.1f} s")
    (sg, rg), (sc, rc) = outs["cuda"], outs["cpu"]
    if len(sg) != len(sc):
        raise AssertionError(f"{family} streaming step counts differ: {len(sg)} vs {len(sc)}")
    diff = max(float((g - c).abs().max()) for g, c in zip(sg, sc))
    log(f"[5] {family} streaming encoder card vs CPU: max abs diff over {len(sg)} steps "
        f"{diff:.3e}; tokens identical: {rg.tokens == rc.tokens}")
    for i, (g, c) in enumerate(zip(sg, sc)):
        if not torch.allclose(g, c, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{family} streaming step {i} card vs CPU beyond rtol/atol 1e-3")
    if rg.tokens != rc.tokens or rg.timestamps != rc.timestamps:
        raise AssertionError(f"{family}: streaming tokens differ between card and CPU")


def phase_full_width_vs_cpu(family, cfg=None, name=None, tag="[5]"):
    """One family at full width from a seed (``cfg``: another config of it,
    run as ``name``), one 5 s utterance in float32, card against CPU: the
    encoder output within rtol/atol 1e-3, tokens and timestamps identical.
    Returns the card run's attention launches."""
    cfg = cfg or FAMILIES[family]["cfg"]()
    name = name or family
    pcm = [synth_pcm(5 * 16000, 101)]
    outs = {}
    launches = 0
    for dev in ("cuda", "cpu"):
        bundle = ModelBundle.random(family, cfg, vocab_size=500, seed=0, device=dev)
        rec = OfflineRecognizer(bundle, compute_dtype=None, device=dev)
        t0 = time.time()
        samples, counts = rec.pcm_batch(streams_for(rec, pcm))
        enc, lens = rec.encode(samples, counts)
        reset_counts()
        res = rec.get_results(streams_for(rec, pcm))[0]
        if dev == "cuda":
            launches = family_launches(f"{name}_card_vs_cpu_offline", FAMILIES[family],
                                       read_counts())
        outs[dev] = (enc.float().cpu(), lens.cpu(), res)
        log(f"{tag} {name} full width f32 on {dev}: enc {tuple(enc.shape)}, "
            f"{len(res.tokens)} tokens, {time.time() - t0:.1f} s")
    (eg, lg, rg), (ec, lc, rc) = outs["cuda"], outs["cpu"]
    if not torch.equal(lg, lc):
        raise AssertionError(f"{name} enc lens differ: {lg} vs {lc}")
    diff = float((eg - ec).abs().max())
    scale = float(ec.abs().max())
    log(f"{tag} {name} encoder card vs CPU: max abs diff {diff:.3e} (max |enc| {scale:.3f}); "
        f"tokens identical: {rg.tokens == rc.tokens} ({len(rg.tokens)} tokens)")
    if not torch.allclose(eg, ec, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"{name} encoder output card vs CPU beyond rtol/atol 1e-3 ({diff})")
    if rg.tokens != rc.tokens or rg.timestamps != rc.timestamps:
        raise AssertionError(f"{name}: tokens differ between card and CPU")
    return launches


def phase_main_path(family, method="greedy_search", n_batches=2, accuracy=None):
    """An offline main path (a CTC family always decodes CTC greedy) through
    begin_decode's CUDA graph: the first batch captures it (its host ms with
    the warm-up run, the capture and the replay); a second capture of the
    same key, in a program of its own under graph_dump, has its kernel
    nodes counted by name against one batch's launches; then ``n_batches``
    timed, the launches counted from 0 over them (the replay adds what the
    capture recorded); each timed batch again through the graph, held bit
    for bit against eager _decode of the same batch (graph_audit), whose
    beam search is held to the beam replay; the device's busy share over 3
    batches, with the kernels the profiler traced held against the counts,
    and one replay's device time.
    ``accuracy="int8"``: the encoder's linears in int8 ([8]).  Returns
    (the family kernel's launches, the path's numbers)."""
    spec = FAMILIES[family]
    bundle = ModelBundle.random(family, spec["cfg"](), vocab_size=500, seed=0, device="cuda")
    rec = OfflineRecognizer(bundle, decoding_method=method, max_active_paths=BEAM_K,
                            accuracy=accuracy, device="cuda")  # bf16 compute
    name = f"{family}/{rec.decoding_method}" + (f"/{accuracy}" if accuracy else "")
    tag = "[8]" if accuracy else "[6]"
    n = 30 * 16000
    batches = [streams_for(rec, [synth_pcm(n, k * FLAGSHIP_B + i) for i in range(FLAGSHIP_B)])
               for k in range(n_batches + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.get_results(batches[0])  # the shape's capture: a warm-up run, the capture, a replay
    first_ms = (time.perf_counter() - t0) * 1e3
    (key, entry), = rec.program.entries.items()
    search = search_kernel(spec, rec.decoding_method)
    per_batch = replay_counts(spec, search)
    with graph_dump() as dumped, torch.inference_mode():
        DecodeProgram(rec._decode, rec.device)(*entry.inputs)
    nodes, n_nodes = graph_kernel_nodes(dumped[0])
    del dumped
    gc.collect()
    torch.cuda.empty_cache()  # the dumped graph's pool
    log(f"{tag} {name} graph of key (rows, samples) {key}: captured with its first batch in "
        f"{first_ms:.1f} ms (warm-up run, capture, replay); launches per replay "
        f"{dict(zip(KERNELS, entry.launches))}; a second capture of the key, dumped: "
        f"{n_nodes} nodes, kernel nodes {nodes}")
    if nodes != per_batch or dict(zip(KERNELS, entry.launches)) != per_batch:
        raise AssertionError(f"{name}: the graph holds kernel nodes {nodes} and records "
                             f"{entry.launches}, expected one batch's {per_batch}")
    reset_peak_memory()

    reset_counts()
    before = profiling.counters()
    convs = L.conv_tf32.launches
    t0 = time.time()
    results = []
    for k in range(1, n_batches + 1):
        results.extend(rec.end_decode(rec.begin_decode(batches[k])))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    check_conv_tf32(name, spec, entry.launches[-1], L.conv_tf32.launches - convs, n_batches)
    ran = counters_since(before)
    if ran.get("program.replays") != n_batches or ran.get("program.captures"):
        raise AssertionError(f"{name}: {n_batches} timed batches ran {ran} (profiling "
                             f"counters), expected one replay a batch and no capture")

    want = {k: v * n_batches for k, v in per_batch.items()}
    if counts != want:
        raise AssertionError(f"{name} main path launched {counts}, expected {want}")
    if search:
        SEARCH_PATHS[search][name] = counts[search]
    if spec["swoosh"]:
        SWOOSH_PATHS[name] = counts["bias_swoosh"]
    ms_batch = wall / n_batches * 1e3
    audio_rate = n_batches * FLAGSHIP_B * 30.0 / wall
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool = rec.program.pool_bytes() / 2**30
    toks = [len(r.tokens) for r in results]

    # each timed batch again: the graph's outputs against eager _decode (and,
    # under beam search, eager's search against the plain ops)
    with beam_capture() as searches, graph_audit() as audited:
        again = [r for k in range(1, n_batches + 1)
                 for r in rec.end_decode(rec.begin_decode(batches[k]))]
    if [(r.tokens, r.timestamps) for r in again] != [(r.tokens, r.timestamps) for r in results]:
        raise AssertionError(f"{name}: a batch decoded again gave other tokens")
    if len(audited) != n_batches or any(new for _, new in audited):
        raise AssertionError(f"{name}: {audited} calls of the program, expected {n_batches} "
                             f"replays")
    busy, traced = device_trace(lambda: rec.end_decode(rec.begin_decode(batches[1])), reps=3)
    replayed = read_counts()
    if busy is not None and traced != replayed:
        raise AssertionError(f"{name}: the profiler traced kernels {traced} over 3 replays, the "
                             f"counters say {replayed}")
    samples, sample_counts = rec.pcm_batch(batches[1])
    with torch.inference_mode():
        replay_ms = device_ms(lambda: rec.program(samples, sample_counts), reps=3)

    # one more batch split into stages (not part of the counted run)
    torch.cuda.synchronize()
    t0 = time.time()
    samples, sample_counts = rec.pcm_batch(batches[1])
    torch.cuda.synchronize()
    t1 = time.time()
    enc, lens = rec.encode(samples, sample_counts)
    torch.cuda.synchronize()
    t2 = time.time()
    if not bool(torch.isfinite(enc).all()) or enc.shape[0] != FLAGSHIP_B:
        raise AssertionError(f"{name} encoder output not finite or wrong batch")
    pending = rec.begin_decode(batches[1])
    rec.end_decode(pending)
    torch.cuda.synchronize()
    t3 = time.time()
    prep_ms, enc_ms, full_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3
    if min(toks) == 0 or max(toks) > rec.max_tokens:
        raise AssertionError(f"{name}: implausible token counts {min(toks)}..{max(toks)}")
    if len(pending.host) == 4:  # beam: the n-best sorted, finite scores
        score = pending.host[3]
        if not bool(torch.isfinite(score).all()) or bool((score[:, 1:] > score[:, :-1]).any()):
            raise AssertionError(f"{name}: n-best scores not finite or not sorted")
    if search == "rnnt_greedy" and not accuracy:
        greedy_replay(name, rec, enc, lens)
    if searches:
        beam_replays(tag, name, rec, searches)
    log(f"{tag} {name} main path bf16, {n_batches} batches x {FLAGSHIP_B} x 30 s, each one "
        f"graph replay: {ms_batch:.1f} ms/batch, {audio_rate:.1f} audio-s/s, peak "
        f"{peak:.2f} GiB allocated with the graph held, its pool {pool:.3f} GiB, launches "
        f"{counts} ({spec['per_batch']}/batch of {spec['kernel']}), tokens/utt "
        f"{statistics.mean(toks):.1f} (min {min(toks)} max {max(toks)}), enc out "
        f"{tuple(enc.shape)}, conv_tf32 {CONV_TF32_PATHS[name]}")
    log(f"{tag} {name} graph vs eager _decode: {len(audited)} batches bit for bit; one "
        f"replay's device time {replay_ms:.2f} ms (calls queued behind a spin); device busy "
        + ("not measured (the profiler recorded no device activity), nor the traced kernels"
           if busy is None else
           f"{busy:.1%} of 3 profiled batches' wall time (the profiler's host cost included); "
           f"kernels in the trace by name {traced}, equal to the counters"))
    log(f"{tag} {name} stage split (host clock, one batch): host prep and upload (pcm_batch) "
        f"{prep_ms:.1f} ms, eager fbank+encoder {enc_ms:.1f} ms; whole decode (graph) "
        f"{full_ms:.1f} ms")
    row = {"path": name, "ms_per_batch": ms_batch, "audio_s_per_s": audio_rate,
           "first_batch_ms": first_ms, "replay_device_ms": replay_ms,
           "device_busy_share": busy, "traced_kernels": traced, "peak_gib": peak,
           "graph_pool_gib": pool, "graph_nodes": n_nodes, "kernel_nodes": nodes,
           "prep_ms": prep_ms, "eager_encoder_ms": enc_ms}
    return counts.get(spec["kernel"], 0), row


def pool_leaves(rec) -> list:
    """Every leaf of an online recognizer's lane pool (``_pool``), as it
    lies."""
    leaves = []
    tree_map(leaves.append, rec._pool())
    return leaves


def online_windows(rec, lanes_ready, seed) -> tuple:
    """A whole pool's step inputs on the card: one window of synth_pcm on the
    first ``lanes_ready`` lanes (count 1), zeros and count 0 on the rest."""
    windows = np.zeros((rec.max_lanes, 1, rec.window_samples), np.int16)
    for i in range(lanes_ready):
        windows[i, 0] = np.clip(synth_pcm(rec.window_samples, seed + i) * 32768.0, -32768,
                                32767).astype(np.int16)
    wcount = (np.arange(rec.max_lanes) < lanes_ready).astype(np.int64)
    return torch.from_numpy(windows).cuda(), torch.from_numpy(wcount).cuda()


def step_graph_vs_eager(tag, name, bundle, wps=1, **kw) -> dict:
    """The step graph against the eager step: two recognizers of one bundle
    at STREAM_LANES lanes (the second's program taken away, so begin_step
    runs the same step function eagerly) take the same streams (4 s each)
    until none has a window; every other step passes only the even lanes'
    streams, so half the lanes idle.  After every step (the first, the
    capture's, included) the graph's pool must equal the eager step's bit
    for bit on every leaf, and the partial tokens and timestamps too; the
    lanes that took no window must have kept every leaf bit for bit.  Under
    beam search each eager step's search is held to the beam replay.
    Returns the steps, the half-idle steps and the final tokens."""
    recs = [OnlineRecognizer(bundle, max_lanes=STREAM_LANES, max_active_paths=BEAM_K,
                             windows_per_step=wps, device="cuda", **kw) for _ in range(2)]
    graph, eager = recs
    eager.program = None
    pcms = [synth_pcm(4 * 16000, 500 + i) for i in range(STREAM_LANES)]
    pairs = []
    for rec in recs:
        pairs.append([rec.create_online_stream() for _ in pcms])
        for s, x in zip(pairs[-1], pcms):
            s.add_samples(x)
    steps = half = 0
    calls = []
    while any(s._ready() for s in pairs[0]):
        picks = [ss if steps % 2 == 0 else ss[::2] for ss in pairs]
        stepping = {s.lane for s in picks[0] if s._ready()}
        idle = sorted(set(range(STREAM_LANES)) - stepping)
        before = [t[idle].clone() for t in pool_leaves(graph)]
        res = []
        for rec, streams in zip(recs, picks):
            record = rec is eager and rec.decoding_method == BEAM
            with beam_capture() if record else contextlib.nullcontext([]) as found:
                res.append([(r.tokens, r.timestamps) for r in rec.get_results(streams)])
            calls.extend(found)
        if res[0] != res[1]:
            raise AssertionError(f"{tag} {name} step {steps}: the graph's results differ from "
                                 f"the eager step's")
        for i, (g, e, old) in enumerate(zip(pool_leaves(graph), pool_leaves(eager), before)):
            if g.dtype != e.dtype or not torch.equal(g, e):
                raise AssertionError(f"{tag} {name} step {steps}: pool leaf {i} of the graph "
                                     f"differs from the eager step's")
            if idle and not torch.equal(g[idle], old):
                raise AssertionError(f"{tag} {name} step {steps}: pool leaf {i} of an idle lane "
                                     f"moved")
        half += len(stepping) <= STREAM_LANES // 2
        steps += 1
    if len(graph.program) != 1 or not half:
        raise AssertionError(f"{tag} {name}: {len(graph.program)} graphs, {half} half-idle steps")
    if calls:
        beam_replays(tag, f"{name}/streaming eager", eager, calls)
    final = [(r.tokens, r.timestamps) for r in graph.get_results(pairs[0])]
    if not any(t for t, _ in final):
        raise AssertionError(f"{tag} {name}: no tokens")
    return {"steps": steps, "half_idle_steps": half, "tokens": final}


def phase_streaming_main_path(family, splits, method="greedy_search", seconds=30.0,
                              accuracy=None):
    """The streaming main path as benchmarks/streaming_latency.py drives the
    JAX recognizer: the causal flagship config at bf16, STREAM_LANES lanes
    of ``seconds`` of audio each buffered up front, begin_step + end_step
    over every lane until none has a window, each step one replay of the
    recognizer's CUDA graph.  The first step captures it (its host ms: the
    warm-up on the idle pool, the capture, the replay); a second capture of
    the key, dumped, has its kernel nodes counted by name against one
    step's launches; the device's busy share over 3 steps, with the kernels
    the profiler traced held against the counts; then every step timed on
    the host clock (begin_step's host ms apart), the launches counted from
    0; one replay's device time with all lanes ready and with 2 of them;
    the step with 2 of 16 streams ready against all 16 on the host clock;
    the path's stage split from ``splits`` (phase_stage_splits); and the graph held against the eager step bit for bit
    (step_graph_vs_eager), for zipformer2 greedy also at windows_per_step=2,
    whose tokens must equal one window a step's.  ``accuracy="int8"``: the
    encoder's linears in int8 ([8])."""
    spec = FAMILIES[family]
    tag = "[8]" if accuracy else "[6b]"
    bundle = ModelBundle.random(family, spec["stream_cfg"](), vocab_size=500, seed=0,
                                device="cuda")
    rec = OnlineRecognizer(bundle, decoding_method=method, max_lanes=STREAM_LANES,
                           max_active_paths=BEAM_K, accuracy=accuracy,
                           device="cuda")  # bf16 compute
    name = path_name(rec)
    n = int(16000 * seconds)
    streams = []
    for i in range(STREAM_LANES):
        s = rec.create_online_stream()
        s.add_samples(synth_pcm(n, 300 + i))
        streams.append(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.get_results(streams)  # the capture: a warm-up on the idle pool, the capture, a replay
    capture_ms = (time.perf_counter() - t0) * 1e3
    (key, entry), = rec.program.entries.items()
    search = search_kernel(spec, rec.decoding_method)
    per_step = replay_counts(spec, search)
    with graph_dump() as dumped, torch.inference_mode():
        CudaGraphs(rec.device).capture(rec._step, entry.inputs)  # runs nothing
    nodes, n_nodes = graph_kernel_nodes(dumped[0])
    del dumped
    gc.collect()
    torch.cuda.empty_cache()
    if nodes != per_step or dict(zip(KERNELS, entry.launches)) != per_step:
        raise AssertionError(f"{name} streaming: the graph holds kernel nodes {nodes} and "
                             f"records {entry.launches}, expected one step's {per_step}")
    busy, traced = device_trace(lambda: rec.get_results(streams), reps=3)
    if busy is not None and traced != {k: 3 * v for k, v in per_step.items()}:
        raise AssertionError(f"{name} streaming: the profiler traced kernels {traced} over 3 "
                             f"replays, the counters say {read_counts()}")
    reset_peak_memory()

    reset_counts()
    before = profiling.counters()
    convs = L.conv_tf32.launches
    lat, host, wait, text = [], [], [], []
    t_start = time.perf_counter()
    while any(s._ready() for s in streams):
        t0 = time.perf_counter()
        pending = rec.begin_step(streams)
        t1 = time.perf_counter()
        pending[2].synchronize()  # what end_step waits on first
        t2 = time.perf_counter()
        results = rec.end_step(pending)
        t3 = time.perf_counter()
        lat.append(t3 - t0)
        host.append(t1 - t0)
        wait.append(t2 - t1)
        text.append(t3 - t2)
    wall = time.perf_counter() - t_start
    counts = read_counts()
    steps = len(lat)
    check_conv_tf32(f"{name}/streaming", spec, entry.launches[-1], L.conv_tf32.launches - convs,
                    steps)
    ran = counters_since(before)
    if ran.get("program.replays") != steps or ran.get("program.captures"):
        raise AssertionError(f"{name} streaming: {steps} timed steps ran {ran} (profiling "
                             f"counters), expected one replay a step and no capture")
    lanes_per_replay = ran["online.lanes_stepped"] / steps
    want = {k: v * steps for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{name} streaming main path launched {counts} in {steps} steps, "
                             f"expected {want}")
    if search:
        SEARCH_PATHS[search][f"{name}/streaming"] = counts[search]
    if spec["swoosh"]:
        SWOOSH_PATHS[f"{name}/streaming"] = counts["bias_swoosh"]
    hop_s = rec.hop_samples / bundle.frontend_cfg.sample_rate
    lat_ms = np.array(lat) * 1e3
    p50, p95 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 95))
    toks = [len(r.tokens) for r in results]
    if min(toks) == 0 or max(toks) > rec.max_tokens:
        raise AssertionError(f"{name} streaming: implausible token counts {toks}")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # one replay's device time, every lane ready and 2 of them (not counted)
    with torch.inference_mode():
        full, two = online_windows(rec, STREAM_LANES, 450), online_windows(rec, 2, 450)
        replay_ms = device_ms(lambda: rec.program(*full), reps=3)
        replay_two_ms = device_ms(lambda: rec.program(*two), reps=3)
    # a step with 2 of the 16 streams ready against all 16, host clock
    step_ms = {}
    for ready in (STREAM_LANES, 2, STREAM_LANES, 2):
        for s in streams[:ready]:
            s.add_samples(synth_pcm(rec.window_samples + 2 * rec.hop_samples, 470))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec.get_results(streams[:ready])
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms.setdefault(ready, []).extend(times)
    step_ms = {k: statistics.median(v) for k, v in step_ms.items()}
    stages = splits[name]

    check = step_graph_vs_eager(tag, name, bundle, decoding_method=method, accuracy=accuracy)
    two_windows = None
    if family == "zipformer2" and method == GREEDY and not accuracy:
        two_windows = step_graph_vs_eager(tag, name + " windows_per_step=2", bundle, wps=2,
                                          decoding_method=method)
        if two_windows["tokens"] != check["tokens"]:
            raise AssertionError(f"{tag} {name}: windows_per_step=2 gave other tokens than 1")
    row = {"family": family, "method": rec.decoding_method, "accuracy": accuracy,
           "lanes": STREAM_LANES, "steps": steps, "p50_ms": p50, "p95_ms": p95,
           "hop_ms": hop_s * 1e3, "rtf": p50 / 1e3 / hop_s,
           "audio_s_per_s": STREAM_LANES * hop_s * steps / wall,
           "begin_step_host_ms": float(np.median(host)) * 1e3,
           "end_step_wait_ms": float(np.median(wait)) * 1e3,
           "end_step_results_ms": float(np.median(text)) * 1e3,
           "lanes_per_replay": lanes_per_replay,
           "windows_per_lane": ran["online.windows"] / ran["online.lanes_stepped"],
           "capture_ms": capture_ms, "graph_key": list(key), "graph_nodes": n_nodes,
           "kernel_nodes": nodes, "graph_pool_gib": rec.program.pool_bytes() / 2**30,
           "lane_pool_mib": sum(t.nbytes for t in pool_leaves(rec)) / 2**20, "replay_device_ms": replay_ms,
           "replay_2_of_16_device_ms": replay_two_ms, "step_16_of_16_ms": step_ms[STREAM_LANES],
           "step_2_of_16_ms": step_ms[2], "peak_gib": peak,
           "launches": counts.get(spec["kernel"], 0), "launches_per_step": spec["per_batch"],
           "device_busy_share": busy, "traced_kernels": traced, "stages_ms": stages,
           "graph_vs_eager_steps": check["steps"], "half_idle_steps": check["half_idle_steps"],
           "windows_per_step_2_steps": two_windows and two_windows["steps"]}
    log(f"{tag} {name} streaming main path bf16, {STREAM_LANES} lanes x {seconds:.0f} s, "
        f"{steps} timed steps, each one graph replay: p50 {p50:.2f} ms, p95 {p95:.2f} ms per "
        f"step (hop {hop_s * 1e3:.0f} ms), RTF {row['rtf']:.4f}, "
        f"{row['audio_s_per_s']:.1f} audio-s/s; medians: begin_step host "
        f"{row['begin_step_host_ms']:.2f} ms, then the wait for the card "
        f"{row['end_step_wait_ms']:.2f}, then end_step's results (text) "
        f"{row['end_step_results_ms']:.2f}; lanes stepped per replay {lanes_per_replay:.2f} "
        f"of {STREAM_LANES}, windows per stepped lane {row['windows_per_lane']:.2f} (profiling "
        f"counters); peak {peak:.2f} GiB, launches {counts} "
        f"({spec['per_batch']}/step of {spec['kernel']}), conv_tf32 "
        f"{CONV_TF32_PATHS[name + '/streaming']}, tokens/lane {statistics.mean(toks):.1f}")
    log(f"{tag} {name} step graph of key (lanes, windows, samples) {key}: first step (warm-up "
        f"on the idle pool, capture, replay) {capture_ms:.1f} ms; a second capture, dumped: "
        f"{n_nodes} nodes, kernel nodes {nodes}; graph pool {row['graph_pool_gib']:.3f} GiB, "
        f"lane pool {row['lane_pool_mib']:.2f} MiB; one replay's device time {replay_ms:.3f} ms "
        f"with {STREAM_LANES} lanes ready, {replay_two_ms:.3f} with 2; a step on the host clock "
        f"{step_ms[STREAM_LANES]:.2f} ms with {STREAM_LANES} streams ready, {step_ms[2]:.2f} "
        f"with 2; device busy "
        + ("not measured (the profiler recorded no device activity), nor the traced kernels"
           if busy is None else
           f"{busy:.1%} of 3 profiled steps' wall time (the profiler's host cost included); "
           f"kernels in the trace by name {traced}, equal to the counters"))
    log(f"{tag} {name} step split (device time from each of _step's stage markers to the "
        f"next, per replay of all {STREAM_LANES} lanes under the profiler, another process): "
        + ("not measured (the trace lacks kernels the step launched)" if stages["search"] is None
           else ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
           + f", sum {sum(stages.values()):.3f} beside one replay's {replay_ms:.3f}")
        + f"; the graph against "
        f"the eager step: {check['steps']} steps ({check['half_idle_steps']} with half the lanes "
        f"idle) bit for bit on every pool leaf and on the tokens"
        + ("" if two_windows is None else
           f"; windows_per_step=2: {two_windows['steps']} steps bit for bit against its eager "
           f"step, the tokens of one window a step"))
    del rec, streams
    gc.collect()
    torch.cuda.empty_cache()
    return row


NO_WAIT_BATCHES = 7  # the pipeline's batches (bench.py drives 2-deep over its n_batches)


def _no_sync(what, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any call that
    makes the host wait for the card raises.  Returns (fn's value, its host
    ms)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        raise AssertionError(f"[6c] {what} made the host wait for the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, host


def phase_no_wait() -> dict:
    """[6c] zipformer2 and zipformer2-CTC at full width, 16 x 30 s, bf16:
    begin_decode (one graph replay, the shape captured by a first
    get_results; reference_pad_compat off and on) and begin_step (16 lanes)
    under set_sync_debug_mode("error"), each giving the tokens of the same
    work done with waits, with the eager route's host ms beside; then the
    2-deep pipeline of bench.py:385-395 over NO_WAIT_BATCHES batches against
    the same batches one by one, through the graph and through the eager
    route in turns (eager, graph, graph, eager).  Returns the pipeline's
    numbers."""
    n = 30 * 16000
    pipeline_rec = None
    step_host = {}
    for family in ("zipformer2", "zipformer2ctc"):
        spec = FAMILIES[family]
        bundle = ModelBundle.random(family, spec["cfg"](), vocab_size=500, seed=0, device="cuda")
        for compat in (False, True):
            rec = OfflineRecognizer(bundle, reference_pad_compat=compat, device="cuda")
            batch = streams_for(rec, [synth_pcm(n, 600 + i) for i in range(FLAGSHIP_B)])
            want = [(r.tokens, r.timestamps) for r in rec.get_results(batch)]  # warm, with waits
            pending, host = _no_sync(f"{family} begin_decode (compat {compat})",
                                     lambda: rec.begin_decode(batch))
            t0 = time.perf_counter()
            got = [(r.tokens, r.timestamps) for r in rec.end_decode(pending)]
            wait = (time.perf_counter() - t0) * 1e3
            _, eager = _no_sync(f"{family} eager route", lambda: eager_begin(rec, batch))
            torch.cuda.synchronize()
            log(f"[6c] {family}/{rec.decoding_method} begin_decode, reference_pad_compat={compat}:"
                f" no host sync; host {host:.1f} ms (the eager route {eager:.1f}), then "
                f"end_decode waited {wait:.1f} ms; tokens equal to the run with waits: "
                f"{got == want}")
            if got != want:
                raise AssertionError(f"[6c] {family} begin_decode (compat {compat}) gave other "
                                     f"tokens than get_results")
            if family == "zipformer2" and not compat:
                pipeline_rec = rec
        if family == "zipformer2":
            beam = _no_wait_beam(bundle, n)
        del bundle
        sbundle = ModelBundle.random(family, spec["stream_cfg"](), vocab_size=500, seed=0,
                                     device="cuda")
        # the graph route and the eager route (the same step, its program
        # taken away), step by step in turns on the same streams
        recs = [OnlineRecognizer(sbundle, max_lanes=STREAM_LANES, device="cuda")
                for _ in range(2)]
        recs[1].program = None
        pairs = []
        for online in recs:
            pairs.append([online.create_online_stream() for _ in range(STREAM_LANES)])
            for i, s in enumerate(pairs[-1]):
                s.add_samples(synth_pcm(4 * 16000, 700 + i))
            online.get_results(pairs[-1])  # warm; the graph's capture
        host = {"graph": [], "eager": []}
        while all(s._ready() for s in pairs[0]):
            got = []
            for route, online, streams in zip(host, recs, pairs):
                pending, ms = _no_sync(f"{family} begin_step ({route} route)",
                                       lambda: online.begin_step(streams))
                got.append([(r.tokens, r.timestamps) for r in online.end_step(pending)])
                host[route].append(ms)
            if got[0] != got[1]:
                raise AssertionError(f"[6c] {family}: the graph's step gave other results than "
                                     f"the eager step's")
        steps = {route: statistics.median(ms) for route, ms in host.items() if ms}
        log(f"[6c] {family}/{recs[0].decoding_method} begin_step, {STREAM_LANES} lanes: "
            f"{len(host['graph'])} steps with no host sync, each one graph replay, host "
            f"{steps.get('graph', 0):.2f} ms per step (median; the eager route "
            f"{steps.get('eager', 0):.2f}), the same results")
        if not host["graph"] or len(recs[0].program) != 1:
            raise AssertionError(f"[6c] {family}: no streaming step ran, or not one graph")
        step_host[family] = steps
        if family == "zipformer2":
            beam.update(_no_wait_beam_steps(sbundle))
        del recs, pairs, sbundle

    rec = pipeline_rec
    batches = [streams_for(rec, [synth_pcm(n, 800 + k * FLAGSHIP_B + i)
                                 for i in range(FLAGSHIP_B)]) for k in range(NO_WAIT_BATCHES)]
    audio = NO_WAIT_BATCHES * FLAGSHIP_B * 30.0
    rec.get_results(batches[0])
    routes = {"eager": lambda bt: eager_begin(rec, bt), "graph": rec.begin_decode}
    runs = {"eager": [], "graph": []}
    for route in ("eager", "graph", "graph", "eager"):  # in turns, on one card
        runs[route].append(_pipeline(rec, batches, routes[route]))
    same = len({repr(r[mode]) for rs in runs.values() for r in rs for mode in ("seq", "pipe")}) == 1
    out = {"batches": NO_WAIT_BATCHES, "graphs_held": len(rec.program),
           "graph_pool_gib": rec.program.pool_bytes() / 2**30, "beam": beam,
           "begin_step_host_ms": step_host}
    for route, rs in runs.items():
        seq_s = statistics.mean(r["seq_s"] for r in rs)
        pipe_s = statistics.mean(r["pipe_s"] for r in rs)
        out[route] = dict(sequential_audio_s_per_s=audio / seq_s,
                          pipelined_audio_s_per_s=audio / pipe_s,
                          sequential_batch_ms=seq_s / NO_WAIT_BATCHES * 1e3,
                          pipelined_batch_ms=pipe_s / NO_WAIT_BATCHES * 1e3,
                          begin_decode_host_ms=statistics.mean(
                              h for r in rs for h in r["host"]) * 1e3,
                          runs=[{k: r[k] for k in ("seq_s", "pipe_s")} for r in rs])
        how = "one graph replay" if route == "graph" else "eager _decode"
        log(f"[6c] zipformer2/greedy_search pipeline, {route} route ({how} per batch), "
            f"{NO_WAIT_BATCHES} batches x {FLAGSHIP_B} x 30 s bf16, mean of {len(rs)} runs: "
            f"sequential {out[route]['sequential_audio_s_per_s']:.1f} audio-s/s "
            f"({out[route]['sequential_batch_ms']:.1f} ms/batch), 2-deep pipelined "
            f"{out[route]['pipelined_audio_s_per_s']:.1f} audio-s/s "
            f"({out[route]['pipelined_batch_ms']:.1f} ms/batch); begin_decode host "
            f"{out[route]['begin_decode_host_ms']:.1f} ms per batch")
    log(f"[6c] zipformer2/greedy_search: {out['graphs_held']} graph held, its pool "
        f"{out['graph_pool_gib']:.3f} GiB; tokens equal across routes, sequential and "
        f"pipelined: {same}")
    if not same:
        raise AssertionError("[6c] the pipelined or eager batches gave other tokens than the "
                             "sequential graph replays")
    return out


GRAPH_MEMORY_SECONDS = (30, 20, 10)  # [6d]: one bucket each, 16 utterances a batch


def _pool_segments(pool) -> tuple[int, int]:
    """(bytes reserved, bytes allocated) in the segments of a graph pool."""
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool)]
    return sum(seg["total_size"] for seg in segs), sum(seg["allocated_size"] for seg in segs)


def phase_graph_memory() -> dict:
    """[6d] What a recognizer's graphs hold on the card: zipformer2 greedy at
    full width, bf16, 16 rows.  Eager _decode of a 30 s batch from an
    emptied cache: its peak allocated and its peak reserved above what was
    alive before.  Then the graphs of the 30, 20 and 10 s buckets captured
    in turn (each with its warm-up run on the program's side stream): after
    each, the pool's reserved bytes, the bytes allocated in it (the static
    outputs) and what the allocator reserves outside the pool above the
    start (the warm-up runs' blocks, cached for the side stream).  Last the
    recognizer dropped with the cycle collector off: its pool's segments
    left after empty_cache, which must be none."""
    spec = FAMILIES["zipformer2"]
    bundle = ModelBundle.random("zipformer2", spec["cfg"](), vocab_size=500, seed=0,
                                device="cuda")
    rec = OfflineRecognizer(bundle, device="cuda")
    batches = {sec: streams_for(rec, [synth_pcm(sec * 16000, 1000 + sec + i)
                                      for i in range(FLAGSHIP_B)])
               for sec in GRAPH_MEMORY_SECONDS}
    gib = 2.0**-30
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_alloc, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    samples, counts = rec.pcm_batch(batches[GRAPH_MEMORY_SECONDS[0]])
    with torch.inference_mode():
        rec._decode(samples, counts)
    torch.cuda.synchronize()
    out = {"eager_peak_allocated_gib": (torch.cuda.max_memory_allocated() - base_alloc) * gib,
           "eager_peak_reserved_gib": (torch.cuda.max_memory_reserved() - base_res) * gib,
           "graphs": []}
    del samples, counts
    torch.cuda.empty_cache()
    log(f"[6d] zipformer2/greedy_search eager _decode of 16 x {GRAPH_MEMORY_SECONDS[0]} s from "
        f"an emptied cache: peak allocated {out['eager_peak_allocated_gib']:.3f} GiB, peak "
        f"reserved {out['eager_peak_reserved_gib']:.3f} GiB above what was alive")
    pool = rec.program.graphs.pool
    for sec in GRAPH_MEMORY_SECONDS:
        t0 = time.perf_counter()
        rec.get_results(batches[sec])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        reserved, live = _pool_segments(pool)
        row = {"seconds": sec, "key": list(rec.program.entries)[-1], "first_batch_ms": ms,
               "pool_gib": reserved * gib, "pool_allocated_gib": live * gib,
               "outside_pool_gib": (torch.cuda.memory_reserved() - base_res - reserved) * gib}
        out["graphs"].append(row)
        log(f"[6d] {len(rec.program)} graph(s) after the {sec} s bucket (key {row['key']}, "
            f"first batch {ms:.1f} ms): pool {row['pool_gib']:.3f} GiB reserved, "
            f"{row['pool_allocated_gib']:.4f} GiB of it allocated (the static outputs); "
            f"reserved outside the pool above the start {row['outside_pool_gib']:.3f} GiB")
    gc.disable()
    try:
        del rec
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left, _ = _pool_segments(pool)
        after = (torch.cuda.memory_reserved() - base_res) * gib
    finally:
        gc.enable()
    out.update(pool_left_after_drop_gib=left * gib, reserved_after_drop_gib=after)
    log(f"[6d] recognizer dropped, cycle collector off, empty_cache: its pool's segments left "
        f"{left * gib:.3f} GiB; reserved above the start {after:.3f} GiB")
    if left:
        raise AssertionError("[6d] a dropped recognizer's graph pool stayed on the card")
    return out


def _pipeline(rec, batches, begin) -> dict:
    """The batches one by one (begin, then end_decode), then 2-deep as
    bench.py drives them (batch k+1 begun before batch k is ended): the wall
    seconds of each, begin's host seconds per pipelined batch and the tokens."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [rec.end_decode(begin(bt)) for bt in batches]
    seq_s = time.perf_counter() - t0
    host = []
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    pending = begin(batches[0])
    host.append(time.perf_counter() - t1)
    pipe = []
    for k in range(1, len(batches)):
        t1 = time.perf_counter()
        nxt = begin(batches[k])
        host.append(time.perf_counter() - t1)
        pipe.append(rec.end_decode(pending))
        pending = nxt
    pipe.append(rec.end_decode(pending))
    pipe_s = time.perf_counter() - t0
    return {"seq_s": seq_s, "pipe_s": pipe_s, "host": host,
            "seq": [[r.tokens for r in b] for b in seq],
            "pipe": [[r.tokens for r in b] for b in pipe]}


NO_WAIT_HOTWORDS = ["tok7tok7"]  # any text: the n-best is read back and ranked on the host


def _no_wait_beam(bundle, n) -> dict:
    """[6c] under modified_beam_search (K=4), without and with hotwords: a
    16 x 30 s begin_decode under set_sync_debug_mode("error") gives the
    tokens of get_results; its host ms and end_decode's wait are returned."""
    out = {}
    for hotwords in (None, NO_WAIT_HOTWORDS):
        rec = OfflineRecognizer(bundle, decoding_method=BEAM, max_active_paths=BEAM_K,
                                hotwords=hotwords, device="cuda")
        what = f"zipformer2/{BEAM}" + ("/hotwords" if hotwords else "")
        batch = streams_for(rec, [synth_pcm(n, 900 + i) for i in range(FLAGSHIP_B)])
        want = [(r.tokens, r.timestamps) for r in rec.get_results(batch)]  # warm, with waits
        reset_counts()
        pending, host = _no_sync(f"{what} begin_decode", lambda: rec.begin_decode(batch))
        t0 = time.perf_counter()
        got = [(r.tokens, r.timestamps) for r in rec.end_decode(pending)]
        wait = (time.perf_counter() - t0) * 1e3
        family_launches(f"no_wait_{what}", FAMILIES["zipformer2"], read_counts(), BEAM)
        _, eager = _no_sync(f"{what} eager route", lambda: eager_begin(rec, batch))
        torch.cuda.synchronize()
        log(f"[6c] {what} begin_decode: no host sync; host {host:.1f} ms (the eager route "
            f"{eager:.1f}), then end_decode waited {wait:.1f} ms; tokens equal to the run with "
            f"waits: {got == want}")
        if got != want:
            raise AssertionError(f"[6c] {what} begin_decode gave other tokens than get_results")
        out["hotwords" if hotwords else "plain"] = dict(
            begin_decode_host_ms=host, eager_begin_host_ms=eager, end_decode_wait_ms=wait)
    return out


def _no_wait_beam_steps(sbundle) -> dict:
    """[6c] begin_step under modified_beam_search (K=4, 16 lanes), without
    and with hotwords, under set_sync_debug_mode("error"), through the graph
    and through the eager route (the same step, the program taken away);
    each run's partial results equal those of the same steps taken through
    the graph with end_step's waits in between.  Returns the median host ms
    per step of each route."""
    out = {}
    for hotwords in (None, NO_WAIT_HOTWORDS):
        what = f"zipformer2/{BEAM}" + ("/hotwords" if hotwords else "")
        texts, host = {}, {"graph": [], "eager": []}
        for route in ("waits", "graph", "eager"):
            online = OnlineRecognizer(sbundle, decoding_method=BEAM, max_active_paths=BEAM_K,
                                      hotwords=hotwords, max_lanes=STREAM_LANES, device="cuda")
            if route == "eager":
                online.program = None
            streams = []
            for i in range(STREAM_LANES):
                s = online.create_online_stream()
                s.add_samples(synth_pcm(4 * 16000, 700 + i))
                streams.append(s)
            online.get_results(streams)  # warm; the graph's capture
            reset_counts()
            steps = []
            while all(s._ready() for s in streams):
                if route in host:
                    pending, ms = _no_sync(f"{what} begin_step ({route} route)",
                                           lambda: online.begin_step(streams))
                    host[route].append(ms)
                else:
                    pending = online.begin_step(streams)
                steps.append([r.text for r in online.end_step(pending)])
            family_launches(f"no_wait_{what}/streaming" + ("" if route == "graph" else
                                                           f"/{route}"),
                            FAMILIES["zipformer2"], read_counts(), BEAM)
            texts[route] = steps
        same = texts["graph"] == texts["waits"] == texts["eager"]
        med = {route: statistics.median(ms) for route, ms in host.items() if ms}
        log(f"[6c] {what} begin_step, {STREAM_LANES} lanes: {len(host['graph'])} steps with no "
            f"host sync, host {med.get('graph', 0):.2f} ms per step through the graph (median; "
            f"the eager route {med.get('eager', 0):.2f}); partial results equal to the steps "
            f"with waits and to the eager route's: {same}")
        if not host["graph"] or not same:
            raise AssertionError(f"[6c] {what}: no step ran, or begin_step gave other results")
        sfx = "_hotwords" if hotwords else ""
        out[f"begin_step_host_ms{sfx}"] = med["graph"]
        out[f"eager_begin_step_host_ms{sfx}"] = med["eager"]
    return out


def device_trace(fn, reps: int) -> tuple[float | None, dict]:
    """``reps`` calls of fn() under a profiler trace: the sum of the
    device's kernel and copy times over the window's wall time, the share
    of it the card was busy (a lower bound: tracing adds host time), and the
    device events named after each of KERNELS (a kernel whose name holds
    it).  The share is None when the profiler recorded no device activity
    (CUPTI tracing is not available on every machine): not measured.
    A profile can miss events at its edges (seen on an H100: the first
    replay's first bias_swoosh; the tail of a streaming step), so one call
    runs before the counted ones and one after, both uncounted: only the
    events of the counted calls' replays count (``counted_window``), and
    the kernels' counters hold the counted calls' launches alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = read_counts()
        fn()
        torch.cuda.synchronize()
    for name, launches in counted.items():
        KERNELS[name].launches = launches
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        return None, {name: 0 for name in KERNELS}
    events = events[counted_window([e.name for e in events], reps)]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    kernels = {name: sum(name in e.name for e in events) for name in KERNELS}
    replays, current = [], []  # each counted replay's kernels, for a mismatch's log
    for e in events:
        current.append(e.name)
        if e.name == profiling.MARKER_PREFIX + "end":
            replays.append({k: sum(k in n for n in current) for k in KERNELS if counted[k]})
            current = []
    if any(r != replays[0] for r in replays):
        log(f"[trace] the profiler's replays differ: {replays}")
    return (busy_us / 1e6 / wall if busy_us else None), kernels


def counted_window(names: list[str], reps: int) -> slice:
    """Of a trace's device events in start order (``names``), those of the
    ``reps`` counted calls between one uncounted call before and one after:
    from after the first ``k2t_stage_end`` marker to the ``reps + 1``-th,
    which ends the last counted replay.  The last call's marker may be
    lost (``reps + 1`` markers); AssertionError for fewer or more."""
    end = profiling.MARKER_PREFIX + "end"
    ends = [i for i, n in enumerate(names) if n == end]
    if len(ends) not in (reps + 1, reps + 2):
        raise AssertionError(f"the profiler traced {len(ends)} {end} markers over {reps} "
                             f"counted calls and two uncounted ones")
    return slice(ends[0] + 1, ends[reps] + 1)


def stage_split(events) -> dict[str, float]:
    """A device trace's time by stage: ``events`` are ``(name, start,
    end)`` of the kernels and copies of one stream in any unit, the stage
    markers (``profiling.stage``: k2t_stage_<stage>) among them.  Each event
    belongs to the stage of the last marker that began at or before it
    (events before the first marker: to the stage that marker ends, as the
    marker sequence shows); the stage's time is the union of its events'
    intervals.  -> {stage: time} for each stage seen, plus "copies": what
    lies between ``end`` and the next ``fbank``.  (``asrbench/`` splits its
    traces with its own copy: the benchmark imports nothing of the port.)"""
    prefix = profiling.MARKER_PREFIX
    events = sorted(events, key=lambda e: e[1])
    marks = [n[len(prefix):] for n, _, _ in events if n.startswith(prefix)]
    before = {}  # stage -> the stage whose marker precedes it
    for prev, cur in zip(marks, marks[1:]):
        before.setdefault(cur, prev)
    current = before.get(marks[0], "end") if marks else "end"
    parts: dict[str, list] = {}
    for n, s, e in events:
        if n.startswith(prefix):
            current = n[len(prefix):]
        parts.setdefault("copies" if current == "end" else current, []).append((s, e))
    return {k: union_length(v) for k, v in parts.items()}


def union_length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, hi = 0.0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def stream_stage_split(rec, per_step: dict) -> dict:
    """Replays of the step graph (every lane stepping) split by the stage
    markers they carry (``profiling.stage``: k2t_stage_<stage>): the device
    time of each of STEP_STAGES, from its marker to the next, and "copies"
    (the static inputs' copies, from ``end`` to the next ``fbank``), in ms
    per replay (stage_split).  Two replays, since a profile in
    a process that profiled before can miss its first events (seen on an
    H100: the first fbank marker): events before the first marker seen go
    to the stage the second replay shows before it.  The values are None
    (not measured) when the trace does not hold each of KERNELS as often as
    the replays launch it (``per_step``).  The pool and the launch counts
    are put back: not part of any counted run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    windows, wcount = online_windows(rec, rec.max_lanes, 400)
    pool = [t.clone() for t in pool_leaves(rec)]
    saved = read_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                rec.program(windows, wcount)
            torch.cuda.synchronize()
    for t, t0 in zip(pool_leaves(rec), pool):
        t.copy_(t0)
    for name, fn in KERNELS.items():
        fn.launches = saved[name]
    device = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    split = stage_split(device)
    stages = {k: split.get(k, 0.0) / 2e3 for k in STEP_STAGES + ("copies",)}
    if {k: sum(k in n for n, _, _ in device) for k in KERNELS} != {
            k: 2 * v for k, v in per_step.items()}:
        return dict.fromkeys(stages)
    return stages


# the streaming main paths (family, method, accuracy) that [6b] and [8] drive
STREAM_PATHS = [(f, GREEDY, None) for f in FAMILIES] + [("zipformer2", BEAM, None),
                                                        ("zipformer2", GREEDY, "int8")]


def path_name(rec) -> str:
    return f"{rec.bundle.model_type}/{rec.decoding_method}" + (
        f"/{rec.accuracy}" if rec.accuracy else "")


def stage_splits() -> int:
    """``--stage-splits``: stream_stage_split of every streaming main path
    (STREAM_PATHS at [6b]'s size, the graph captured first, as [6b] has it
    when it splits), printed as one JSON object {path: stages} on the last
    line."""
    out = {}
    for family, method, accuracy in STREAM_PATHS:
        spec = FAMILIES[family]
        bundle = ModelBundle.random(family, spec["stream_cfg"](), vocab_size=500, seed=0,
                                    device="cuda")
        rec = OnlineRecognizer(bundle, decoding_method=method, max_lanes=STREAM_LANES,
                               max_active_paths=BEAM_K, accuracy=accuracy, device="cuda")
        streams = [rec.create_online_stream() for _ in range(STREAM_LANES)]
        for i, s in enumerate(streams):
            s.add_samples(synth_pcm(4 * 16000, 300 + i))
        rec.get_results(streams)  # the capture
        search = search_kernel(spec, rec.decoding_method)
        out[path_name(rec)] = stream_stage_split(rec, replay_counts(spec, search))
        del rec, streams, bundle
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def phase_stage_splits() -> dict:
    """[6b]'s stage splits, from ``--stage-splits`` in a process of its own
    that has run no profiler before: in this one, after the earlier phases'
    traces, an eager step's trace lacked fbank's kernels and the search
    kernel (seen on an H100), while a fresh process traces every kernel."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stage-splits"],
                          capture_output=True, text=True, timeout=600, check=False)
    if proc.returncode:
        raise AssertionError(f"[6b] --stage-splits exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# [8] int8 against the CPU.  The quantization is exact: w_q8 and w_scale of
# every linear equal the CPU's bit for bit.  The encoder output is not: card
# and CPU sum float32 in other orders (phase 5: a median 7e-8 apart), which
# flips some activation's int8 rounding at a .5 tie; the flip's one-step
# change is then large beside float32 noise and re-rounds later activations
# differently, so after a few layers the two int8 runs differ by about the
# quantization's own noise (measured on an H100: zipformer2 median 9.2e-4
# against int8 - float32's 2.2e-3; conformer 4.4e-3 against 8.7e-3).  So the
# card's int8 may differ from the CPU's int8 by no more than int8 differs
# from float32 on the CPU, in median and in max (a wrong scale, layout or
# product moves outputs by their own size); tokens and timestamps identical.
INT8_MEDIAN_RATIO, INT8_MAX_RATIO = 1.0, 1.0
# the flagship's (Zipformer2Config()) largest linears per 16 x 30 s batch:
# (rows = 16 x stack frames, in, out)
INT_MM_SHAPES = [(16 * 1532, 192, 512), (16 * 766, 256, 768), (16 * 192, 512, 1536),
                 (16 * 192, 1536, 512)]


def phase_int8_vs_cpu(family):
    """accuracy="int8" at full width from a seed, one 5 s utterance,
    float32: the card against the CPU — the quantized weights bit for bit,
    the encoder within INT8_MEDIAN_RATIO, INT8_MAX_RATIO of the CPU's int8 -
    float32 difference, the tokens exactly."""
    cfg = FAMILIES[family]["cfg"]()
    pcm = [synth_pcm(5 * 16000, 101)]
    outs, q8_trees = {}, {}
    for dev in ("cuda", "cpu"):
        bundle = ModelBundle.random(family, cfg, vocab_size=500, seed=0, device=dev)
        for accuracy in ("int8", None) if dev == "cpu" else ("int8",):
            rec = OfflineRecognizer(bundle, compute_dtype=None, accuracy=accuracy, device=dev)
            if accuracy:
                q8_trees[dev] = {k: v.cpu() for k, v in rec.encoder.state_dict().items()
                                 if k.endswith((".w_q8", ".w_scale"))}
            t0 = time.time()
            samples, counts = rec.pcm_batch(streams_for(rec, pcm))
            enc, lens = rec.encode(samples, counts)
            res = rec.get_results(streams_for(rec, pcm))[0]
            q8 = sum(k.endswith(".w_q8") for k in rec.encoder.state_dict())
            outs[dev, accuracy] = (enc.float().cpu(), lens.cpu(), res)
            log(f"[8] {family} {accuracy or 'float32'} full width f32 on {dev}: {q8} linears in "
                f"int8, enc {tuple(enc.shape)}, {len(res.tokens)} tokens, {time.time() - t0:.1f} s")
            if accuracy and not q8:
                raise AssertionError(f"{family}: accuracy='int8' quantized no linear")
    unequal = [k for k, v in q8_trees["cpu"].items() if not torch.equal(q8_trees["cuda"][k], v)]
    log(f"[8] {family} int8 quantization card vs CPU: {len(q8_trees['cpu'])} w_q8/w_scale "
        f"leaves, {len(unequal)} not bit-equal")
    if unequal or set(q8_trees["cuda"]) != set(q8_trees["cpu"]):
        raise AssertionError(f"{family}: int8 weights differ between card and CPU: {unequal[:4]}")
    (eg, lg, rg), (ec, lc, rc), (ef, _, _) = outs["cuda", "int8"], outs["cpu", "int8"], \
        outs["cpu", None]
    if not torch.equal(lg, lc):
        raise AssertionError(f"{family} int8 enc lens differ: {lg} vs {lc}")
    diff, quant = (eg - ec).abs(), (ec - ef).abs()
    med, worst = float(diff.median()), float(diff.max())
    qmed, qmax = float(quant.median()), float(quant.max())
    log(f"[8] {family} int8 encoder card vs CPU: max abs diff {worst:.3e}, median {med:.3e}; "
        f"int8 vs float32 on the CPU: max {qmax:.3e}, median {qmed:.3e} (max |enc| "
        f"{float(ec.abs().max()):.3f}); tokens identical: {rg.tokens == rc.tokens}")
    if med > INT8_MEDIAN_RATIO * qmed or worst > INT8_MAX_RATIO * qmax:
        raise AssertionError(f"{family} int8 encoder card vs CPU: median {med}, max {worst} "
                             f"beyond {INT8_MEDIAN_RATIO}, {INT8_MAX_RATIO} of int8's own "
                             f"{qmed}, {qmax}")
    if rg.tokens != rc.tokens or rg.timestamps != rc.timestamps:
        raise AssertionError(f"{family}: int8 tokens differ between card and CPU")


def phase_int_mm(bw):
    """torch._int_mm (through ops/layers.int8_matmul's padding) against a
    bf16 torch.matmul at the flagship's largest linear shapes, and the whole
    int8 linear (per-token quantisation, product, scales) against the bf16
    one; the int32 product equals the CPU's on the first 256 rows."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(7)
    for m, k, n in INT_MM_SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda")
        w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
        b = torch.randn((n,), generator=g, device="cuda")
        q = L.quantize_linear_int8({"w": w, "b": b})
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        got = L.int8_matmul(xq, q["w_q8"])
        want = L.int8_matmul(xq[:256].cpu(), q["w_q8"].cpu())
        if not torch.equal(got[:256].cpu(), want):
            raise AssertionError(f"int8_matmul {m}x{k}x{n}: card differs from the CPU")
        xb, wb = x.bfloat16(), w.bfloat16()
        ops = 2 * m * k * n
        row = {"m": m, "k": k, "n": n,
               "int_mm_ms": cuda_ms(lambda: L.int8_matmul(xq, q["w_q8"]), reps=20),
               "bf16_mm_ms": cuda_ms(lambda: torch.matmul(xb, wb), reps=20),
               "int8_linear_ms": cuda_ms(lambda: L.apply_linear(q, xb, torch.bfloat16), reps=20),
               "bf16_linear_ms": cuda_ms(
                   lambda: L.apply_linear({"w": w, "b": b}, xb, torch.bfloat16), reps=20)}
        row["int_mm_tops"] = ops / row["int_mm_ms"] / 1e9
        row["bf16_tflops"] = ops / row["bf16_mm_ms"] / 1e9
        row["int_mm_bound_ms"] = max((m * k + k * n + 4 * m * n) / bw, ops / 1979e12) * 1e3
        rows.append(row)
        log(f"[8] int8 product {m}x{k}x{n}: _int_mm {row['int_mm_ms']:.4f} ms "
            f"({row['int_mm_tops']:.1f} TOP/s, bound {row['int_mm_bound_ms']:.4f}), bf16 matmul "
            f"{row['bf16_mm_ms']:.4f} ms ({row['bf16_tflops']:.1f} TFLOP/s); whole linear int8 "
            f"{row['int8_linear_ms']:.4f} ms vs bf16 {row['bf16_linear_ms']:.4f} ms")
        del x, w, b, q, xq, got, xb, wb
    torch.cuda.empty_cache()
    return rows


def _wav_file(path, rate, channels, seconds, seed):
    """A 16-bit wav written with the standard library's wave module."""
    import wave

    n = int(rate * seconds)
    x = np.stack([synth_pcm(n, seed + c) for c in range(channels)], 1)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def phase_ingest():
    """[9] A 5 s, 44.1 kHz, 2-channel, 16-bit wav, read by the port's
    read_wav (the native library, which must have been built) and resampled
    to 16 kHz natively, against the numpy route (wave + numpy decode + numpy
    resampling) on the same file: the zipformer2 pin dir on the card, f32,
    gives the same tokens.  Then FbankConfig.whisper() features on the card
    against the CPU, and dither's noise on the card.  Returns the pin
    decodes' K1 launches."""
    import wave

    from k2transducerasr_tpu_torch import native
    from k2transducerasr_tpu_torch.audio import read_wav, resample_linear
    from k2transducerasr_tpu_torch.audio.wav import _decode_pcm
    from k2transducerasr_tpu_torch.frontend import FbankConfig, FbankExtractor
    from k2transducerasr_tpu_torch.frontend.fbank import dither_noise

    rate = 44100
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ingest.wav")
        _wav_file(path, rate, 2, 5.0, 31)
        if not native.available():
            raise AssertionError("the native audio library was not built (g++)")
        t1 = time.perf_counter()
        audio = read_wav(path)
        pcm_native = native.resample_linear(audio.samples, audio.sample_rate, 16000)
        t2 = time.perf_counter()
        with wave.open(path) as w:
            raw, width, channels = w.readframes(w.getnframes()), w.getsampwidth(), w.getnchannels()
        pcm_numpy = resample_linear(_decode_pcm(raw, width, channels), rate, 16000)
        t3 = time.perf_counter()
        with open(path, "rb") as f:
            direct = native.wav_decode(f.read())
    lib = os.path.relpath(native.get_lib()._name, REPO)
    if direct is None or not np.array_equal(direct[0], audio.samples) or direct[1] != rate:
        raise AssertionError("read_wav's samples are not the native decoder's")
    diff = float(np.abs(pcm_native - pcm_numpy).max())
    log(f"[9] ingest: the native library {lib} (built with g++ at first use); 5 s 44.1 kHz "
        f"stereo wav: native read + resample {(t2 - t1) * 1e3:.2f} ms, numpy route "
        f"{(t3 - t2) * 1e3:.2f} ms (host); {len(pcm_native)} samples at 16 kHz, max |native - "
        f"numpy| {diff:.2e}")
    bundle = ModelBundle.from_dir(os.path.join(PIN_ROOT, "zipformer2_pin"), device="cuda")
    rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
    reset_counts()
    got = [rec.get_result(streams_for(rec, [x])[0]) for x in (pcm_native, pcm_numpy)]
    launches = family_launches("ingest_pin", FAMILIES["zipformer2"], read_counts())
    log(f"[9] zipformer2 pin on card, f32: native route {len(got[0].tokens)} tokens, numpy route "
        f"{len(got[1].tokens)}; identical: {got[0].tokens == got[1].tokens}")
    if (got[0].tokens, got[0].timestamps) != (got[1].tokens, got[1].timestamps):
        raise AssertionError("the native and numpy ingest routes decode differently")

    wcfg = FbankConfig.whisper()
    lens = np.array([80000, 61234, 33333, 16000], np.int32)
    batch = np.zeros((4, 80000), np.float32)
    for i, m in enumerate(lens):
        batch[i, :m] = synth_pcm(int(m), 50 + i)
    fg, ng = FbankExtractor(wcfg, device="cuda")(batch, lens)
    fc, nc = FbankExtractor(wcfg, device="cpu")(batch, lens)
    if not np.array_equal(ng, nc):
        raise AssertionError(f"whisper frame counts differ: {ng} vs {nc}")
    worst = 0.0
    for i, t in enumerate(nc):
        g_, c_ = fg[i, :t].cpu(), fc[i, :t]
        worst = max(worst, float((g_ - c_).abs().max()))
        if not torch.allclose(g_, c_, rtol=1e-4, atol=1e-3):
            raise AssertionError(f"whisper fbank lane {i}: card vs CPU beyond rtol 1e-4 atol 1e-3")
    noise = dither_noise((16, 3000, 400), FbankConfig(dither=1.0), "cuda")
    mean, std = float(noise.mean()), float(noise.std())
    dcfg = FbankConfig(dither=1.0, input_scale=32768.0)
    x = torch.from_numpy(batch).cuda()
    feats = fbank_compute(x, dcfg, 300)
    clean = fbank_compute(x, FbankConfig(input_scale=32768.0), 300)
    log(f"[9] whisper fbank card vs CPU: max abs diff {worst:.3e} over {int(nc.sum())} frames; "
        f"dither 1.0 on the card: noise mean {mean:.2e}, std {std:.5f} over {noise.numel()} "
        f"draws; dithered - clean features std {float((feats[0] - clean[0]).std()):.3e} (lane 0)")
    if abs(mean) > 5e-3 or abs(std - 1.0) > 5e-3:
        raise AssertionError(f"dither noise mean {mean}, std {std}: not N(0, 1)")
    if not bool(torch.isfinite(feats).all()) or torch.equal(feats, clean):
        raise AssertionError("dithered features not finite or equal to the clean ones")
    return launches


def phase_convert(tmp):
    """[10] A synthetic icefall-style ONNX dir (encoder, decoder, joiner,
    tokens) from a full-width Zipformer2Config() random bundle of the port,
    written to ``tmp/onnx`` (kept for [11]), converted by convert_model_dir
    and loaded on the card: a 5 s utterance decodes to the source bundle's
    tokens (f32), with 16 K1 launches (a decode after the one that captured
    the shape's graph).  Returns those launches and the host seconds."""
    from k2transducerasr_tpu_torch.convert.importer import convert_model_dir, export_model_dir

    src = ModelBundle.random("zipformer2", Zipformer2Config(), vocab_size=500, seed=0,
                             device="cuda")
    t0 = time.perf_counter()
    export_model_dir(src, os.path.join(tmp, "onnx"))
    t1 = time.perf_counter()
    convert_model_dir(os.path.join(tmp, "onnx"), os.path.join(tmp, "dir"))
    t2 = time.perf_counter()
    conv = ModelBundle.from_dir(os.path.join(tmp, "dir"), device="cuda")
    t3 = time.perf_counter()
    mb = os.path.getsize(os.path.join(tmp, "onnx", "encoder.onnx")) / 2**20
    with open(os.path.join(tmp, "dir", "IMPORT_REPORT.txt")) as f:
        report = f.read()
    if "UNMAPPED" in report or "initial value" in report:
        raise AssertionError(f"the full-width conversion left weights out:\n{report}")
    pcm = [synth_pcm(5 * 16000, 101)]
    res = []
    for bundle in (src, conv):
        rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
        rec.get_results(streams_for(rec, pcm))  # captures the shape's graph
        reset_counts()
        res.append(rec.get_results(streams_for(rec, pcm))[0])
        counts = read_counts()
    launches = counts["relpos_attn_probs"]
    log(f"[10] convert: full-width zipformer2 export {t1 - t0:.2f} s (encoder.onnx {mb:.0f} MiB),"
        f" convert_model_dir {t2 - t1:.2f} s, from_dir on the card {t3 - t2:.2f} s (host); "
        f"{report.splitlines()[0]}; converted dir on the card, f32: {len(res[1].tokens)} tokens, "
        f"identical to the source bundle's: {res[0].tokens == res[1].tokens}; launches {counts}")
    if (res[0].tokens, res[0].timestamps) != (res[1].tokens, res[1].timestamps):
        raise AssertionError("the converted dir decodes other tokens than its source bundle")
    if counts != replay_counts(FAMILIES["zipformer2"], "rnnt_greedy"):
        raise AssertionError(f"the converted dir's decode launched {counts}")
    GREEDY_PATHS["converted_offline"] = counts["rnnt_greedy"]
    SWOOSH_PATHS["converted_offline"] = counts["bias_swoosh"]
    return launches, t2 - t1


def _pin_wav(path):
    """The pin signal (pin_pcm(6400)) as a 16 kHz 16-bit mono wav whose
    samples are exact int16 values, so the PCM a recognizer decodes from it
    is the pin signal's rounding."""
    import wave

    x = np.clip(np.round(pin_pcm(6400) * 32767), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x.tobytes())


def _captured(fn, *args):
    """fn(*args) with its stdout captured: (its return value, the lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue().splitlines()


def phase_cli(tmp) -> dict:
    """[11] The port's CLI and demos in this process, on the card, as a user
    runs them (bf16, the CLI's compute): ``-type offline -batch multi`` and
    ``-type online`` on the zipformer2 pin dir with the pin signal as a wav
    must print the pinned transcripts, the demos the same, and ``convert`` on
    [10]'s synthetic ONNX dir must exit 0.  Each offline decode and each
    streaming step must run through the recognizer's CUDA graph, held bit
    for bit against the eager run (graph_audit).  Returns each run's K1
    launches."""
    from k2transducerasr_tpu_torch.cli.main import main as cli_main
    from k2transducerasr_tpu_torch.examples import offline_demo, online_demo

    spec = FAMILIES["zipformer2"]
    pin_dir = os.path.join(PIN_ROOT, "zipformer2_pin")
    wav = os.path.join(tmp, "pin.wav")
    _pin_wav(wav)
    launches = {}
    runs = [("cli_offline", cli_main, ["-base", pin_dir, "-type", "offline", "-batch", "multi",
                                       "-files", wav], spec["pin_text"]),
            ("cli_online", cli_main, ["-base", pin_dir, "-type", "online", "-files", wav],
             spec["online_pin_text"]),
            ("demo_offline", offline_demo.main, [pin_dir, wav], spec["pin_text"]),
            ("demo_online", online_demo.main, [pin_dir, wav], spec["online_pin_text"])]
    for name, fn, argv, pin in runs:
        reset_counts()
        t0 = time.perf_counter()
        with graph_audit() as audited:
            rc, lines = _captured(fn, argv)
        secs = time.perf_counter() - t0
        counts = read_counts()
        # the online demo prints each partial after a carriage return
        # (splitlines splits there): its final text is the line before the
        # report's three lines and "end!"
        text = lines[-5] if name == "demo_online" else lines[1]
        how = "decode(s)" if name.endswith("_offline") else "step(s)"
        log(f"[11] {name}: exit {rc}, printed {text!r}, {secs:.2f} s host, launches {counts}; "
            f"{len(audited)} {how} through the graph, equal to the eager run bit for bit")
        if rc not in (0, None) or text != pin:
            raise AssertionError(f"[11] {name} printed {lines!r}; expected {pin!r}")
        if not audited:
            raise AssertionError(f"[11] {name} ran without the recognizer's graph")
        launches[name] = family_launches(name, spec, counts)
    t0 = time.perf_counter()
    rc, lines = _captured(cli_main, ["convert", os.path.join(tmp, "onnx"),
                                     os.path.join(tmp, "cli_dir")])
    log(f"[11] cli convert of [10]'s full-width ONNX dir: exit {rc}, {lines[-1]!r}, "
        f"{time.perf_counter() - t0:.2f} s host")
    if rc != 0:
        raise AssertionError(f"[11] cli convert exited {rc}")
    return launches


# [12] parallel on the one card: two ranks (processes) of this script
PAR_PCMS = [(5 * 16000, 121), (5 * 16000, 122)]  # two 5 s utterances (synth_pcm)
PAR_STREAMS = [(5 * 16000, 131 + i) for i in range(4)]  # four 5 s streams, 4 lanes
PAR_ATOL = 1e-3  # the encoder output, TP against one process: float32 summation order
PAR_TIMEOUT = 300


def _par_offline(rec):
    """One offline batch of PAR_PCMS: (tokens and timestamps, host ms), the
    batch timed after a warm-up."""
    pcms = [synth_pcm(n, seed) for n, seed in PAR_PCMS]
    rec.get_results(streams_for(rec, pcms))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = rec.get_results(streams_for(rec, pcms))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return [(r.tokens, r.timestamps) for r in res], ms


def _par_streaming(rec):
    """PAR_STREAMS buffered up front, get_results until no window is left,
    then drained: (each stream's final tokens and timestamps, steps, host
    ms)."""
    streams = [rec.create_online_stream() for _ in PAR_STREAMS]
    for s, (n, seed) in zip(streams, PAR_STREAMS):
        s.add_samples(synth_pcm(n, seed))
    reset_counts()
    t0 = time.perf_counter()
    steps = 0
    while any(s._ready() for s in streams):
        rec.get_results(streams)
        steps += 1
    res = [rec.decode_to_end(s) for s in streams]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return [(r.tokens, r.timestamps) for r in res], steps, ms


def _tree_bytes(tree) -> int:
    """Bytes of a parameter tree's tensors (a ModelShard: its local slice)."""
    from k2transducerasr_tpu_torch.parallel.sharding import ModelShard

    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, ModelShard):
        tree = tree.local
    return 0 if tree is None else tree.numel() * tree.element_size()


def parallel_rank(job_path: str, rank: int) -> int:
    """One rank of [12] (``chip_smoke.py --parallel-rank JOB RANK``): joins
    the job's process group, runs TP on mesh 1x2 (zipformer2 and conformer,
    full width, f32, offline) and DP on mesh 2x1 (zipformer2 offline and
    streaming), and writes what each returned, its launches, peak memory
    and parameter bytes to ``<out>.rank<rank>.pkl``."""
    import pickle

    import torch.distributed as dist

    from k2transducerasr_tpu_torch.parallel import distributed as D
    from k2transducerasr_tpu_torch.parallel.sharding import make_mesh

    with open(job_path) as f:
        job = json.load(f)
    dev = torch.device("cuda", rank if job["backend"] == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if not D.initialize(job["init"], 2, rank, backend=job["backend"]):
        raise AssertionError("initialize() returned False for 2 processes")
    out = {"rank": rank, "backend": dist.get_backend()}
    try:
        tp = make_mesh(1, 2)
        for family in ("zipformer2", "conformer"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            bundle = ModelBundle.random(family, FAMILIES[family]["cfg"](), vocab_size=500,
                                        seed=0, device=dev)
            rec = OfflineRecognizer(bundle, compute_dtype=None, mesh=tp, device=dev)
            res, ms = _par_offline(rec)
            counts = read_counts()
            enc, lens = rec.encode(*rec.pcm_batch(streams_for(
                rec, [synth_pcm(n, seed) for n, seed in PAR_PCMS])))
            out[f"tp_{family}"] = dict(
                results=res, ms=ms, launches=counts, enc=enc.cpu().numpy(), lens=lens.cpu().numpy(),
                peak=torch.cuda.max_memory_allocated(dev), held=_tree_bytes(rec.encoder.tree()),
                whole=_tree_bytes(bundle.encoder.tree()))
            del rec, bundle
        dp = make_mesh(2, 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        bundle = ModelBundle.random("zipformer2", Zipformer2Config(), vocab_size=500, seed=0,
                                    device=dev)
        res, ms = _par_offline(OfflineRecognizer(bundle, compute_dtype=None, mesh=dp, device=dev))
        out["dp_offline"] = dict(results=res, ms=ms, launches=read_counts(),
                                 peak=torch.cuda.max_memory_allocated(dev))
        res, ms = _par_offline(OfflineRecognizer(bundle, decoding_method=BEAM,
                                                 max_active_paths=BEAM_K, compute_dtype=None,
                                                 mesh=dp, device=dev))
        out["dp_beam_offline"] = dict(results=res, ms=ms, launches=read_counts(),
                                      peak=torch.cuda.max_memory_allocated(dev))
        del bundle
        bundle = ModelBundle.random("zipformer2", FAMILIES["zipformer2"]["stream_cfg"](),
                                    vocab_size=500, seed=0, device=dev)
        rec = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=len(PAR_STREAMS), mesh=dp,
                               device=dev)
        res, steps, ms = _par_streaming(rec)
        out["dp_streaming"] = dict(results=res, steps=steps, ms=ms, launches=read_counts(),
                                   peak=torch.cuda.max_memory_allocated(dev))
        with open(f"{job['out']}.rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_ranks(tmp, backend: str) -> list[dict]:
    """Two ranks of this script on the job; both must exit 0 within
    PAR_TIMEOUT (a rank still running then is killed)."""
    import pickle

    sub = os.path.join(tmp, backend)
    os.makedirs(sub)
    job = {"backend": backend, "init": f"file://{sub}/rdzv", "out": f"{sub}/out"}
    with open(os.path.join(sub, "job.json"), "w") as f:
        json.dump(job, f)
    procs, logs = [], []
    try:
        for rank in range(2):
            logs.append(open(os.path.join(sub, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(  # faulthandler: a crash prints its stack
                [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
                 "--parallel-rank", os.path.join(sub, "job.json"), str(rank)], cwd=REPO,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PAR_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for log_file in logs:
            log_file.seek(0)
            tails.append(log_file.read()[-4000:])
            log_file.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"[12] {backend} rank {rank} exited {p.returncode}:\n{tails[rank]}")
    out = []
    for rank in range(2):
        with open(f"{job['out']}.rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def phase_parallel(tmp) -> dict:
    """[12] Data and tensor parallelism on the one card: the single-process
    runs here, then two ranks (``--parallel-rank``) in a gloo group passing
    CUDA tensors, TP on mesh 1x2 and DP on mesh 2x1; tokens and timestamps
    must equal the single process's, the TP encoder output within PAR_ATOL,
    and every rank must launch its kernels.  With two or more cards, the
    same with NCCL.  Returns the K1/K2 launches of each path, summed over the
    ranks of the gloo run."""
    ref = {}
    for family in ("zipformer2", "conformer"):
        bundle = ModelBundle.random(family, FAMILIES[family]["cfg"](), vocab_size=500, seed=0,
                                    device="cuda")
        rec = OfflineRecognizer(bundle, compute_dtype=None, device="cuda")
        res, ms = _par_offline(rec)
        enc, lens = rec.encode(*rec.pcm_batch(streams_for(
            rec, [synth_pcm(n, seed) for n, seed in PAR_PCMS])))
        ref[family] = dict(results=res, ms=ms, enc=enc.cpu().numpy(), lens=lens.cpu().numpy())
        if family == "zipformer2":
            res, ms = _par_offline(OfflineRecognizer(bundle, decoding_method=BEAM,
                                                     max_active_paths=BEAM_K, compute_dtype=None,
                                                     device="cuda"))
            ref["beam"] = dict(results=res, ms=ms)
        del rec, bundle
    bundle = ModelBundle.random("zipformer2", FAMILIES["zipformer2"]["stream_cfg"](),
                                vocab_size=500, seed=0, device="cuda")
    rec = OnlineRecognizer(bundle, compute_dtype=None, max_lanes=len(PAR_STREAMS), device="cuda")
    ref["streaming"] = dict(zip(("results", "steps", "ms"), _par_streaming(rec)))
    del rec, bundle
    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[12] one process on {smi}: TP reference batches (2 x 5 s, f32) zipformer2 "
        f"{ref['zipformer2']['ms']:.1f} ms, conformer {ref['conformer']['ms']:.1f} ms; "
        f"streaming 4 lanes x 5 s {ref['streaming']['steps']} steps {ref['streaming']['ms']:.1f} ms")
    log("[12] gloo: NCCL refuses two ranks on one device ('Duplicate GPU detected'), so the two "
        "ranks join a gloo group and pass CUDA tensors through it (all_gather_into_tensor, "
        "all_reduce)")
    runs = {"gloo": _spawn_ranks(tmp, "gloo")}
    if torch.cuda.device_count() >= 2:
        runs["nccl"] = _spawn_ranks(tmp, "nccl")
    else:
        log("[12] nccl: not run (one card)")
    want_tp = {family: replay_counts(FAMILIES[family], "rnnt_greedy")
               for family in ("zipformer2", "conformer")}
    want_dp = want_tp["zipformer2"]
    want_dp_beam = replay_counts(FAMILIES["zipformer2"], "rnnt_beam")
    for backend, ranks in runs.items():
        for r in ranks:
            tag = f"[12] {backend} rank {r['rank']}"
            for family in ("zipformer2", "conformer"):
                got, want = r[f"tp_{family}"], ref[family]
                valid = np.arange(got["enc"].shape[1])[None, :] < want["lens"][:, None]
                diff = float(np.abs(np.where(valid[..., None], got["enc"] - want["enc"], 0)).max())
                log(f"{tag} TP 1x2 {family}: tokens identical {got['results'] == want['results']}, "
                    f"encoder max abs diff {diff:.3e} (atol {PAR_ATOL}), batch {got['ms']:.1f} ms, "
                    f"launches {got['launches']}, peak {got['peak'] / 2**30:.2f} GiB, encoder "
                    f"parameters held {got['held'] / 2**20:.1f} of {got['whole'] / 2**20:.1f} MiB")
                if got["results"] != want["results"] or diff > PAR_ATOL:
                    raise AssertionError(f"{tag} TP {family} differs from one process")
                if got["launches"] != want_tp[family]:
                    raise AssertionError(f"{tag} TP {family} launched {got['launches']}")
            for path, want in (("dp_offline", ref["zipformer2"]), ("dp_beam_offline", ref["beam"]),
                               ("dp_streaming", ref["streaming"])):
                got = r[path]
                log(f"{tag} DP 2x1 {path}: tokens identical {got['results'] == want['results']}, "
                    f"{got['ms']:.1f} ms, launches {got['launches']}, "
                    f"peak {got['peak'] / 2**30:.2f} GiB"
                    + (f", {got['steps']} steps" if "steps" in got else ""))
                if got["results"] != want["results"]:
                    raise AssertionError(f"{tag} {path} differs from one process")
                if path == "dp_offline" and got["launches"] != want_dp:
                    raise AssertionError(f"{tag} {path} launched {got['launches']}")
                if path == "dp_beam_offline" and got["launches"] != want_dp_beam:
                    raise AssertionError(f"{tag} {path} launched {got['launches']}")
                if path == "dp_streaming" and not (got["launches"]["relpos_attn_probs"]
                                                   and got["launches"]["rnnt_greedy"]
                                                   and got["launches"]["bias_swoosh"]):
                    raise AssertionError(f"{tag} {path} launched no K1, rnnt_greedy or "
                                         f"bias_swoosh")
    gloo = runs["gloo"]
    total = lambda path, k: sum(r[path]["launches"][k] for r in gloo)  # noqa: E731
    for r in gloo:  # every rank launches the search kernel on its own rows
        for path in ("tp_zipformer2", "tp_conformer", "dp_offline", "dp_streaming"):
            GREEDY_PATHS[f"{path}_rank{r['rank']}"] = r[path]["launches"]["rnnt_greedy"]
        BEAM_PATHS[f"dp_beam_offline_rank{r['rank']}"] = r["dp_beam_offline"]["launches"][
            "rnnt_beam"]
        for path in ("tp_zipformer2", "dp_offline", "dp_beam_offline", "dp_streaming"):
            SWOOSH_PATHS[f"{path}_rank{r['rank']}"] = r[path]["launches"]["bias_swoosh"]
    return {"relpos_attn_probs": {"tp_offline": total("tp_zipformer2", "relpos_attn_probs"),
                                  "dp_offline": total("dp_offline", "relpos_attn_probs"),
                                  "dp_beam_offline": total("dp_beam_offline",
                                                           "relpos_attn_probs"),
                                  "dp_streaming": total("dp_streaming", "relpos_attn_probs")},
            "relpos_attn_ctx": {"tp_offline": total("tp_conformer", "relpos_attn_ctx")}}


def _family_sums(rows) -> dict:
    """One family's K1/K2 numbers: per flagship batch, its calls at the bf16
    main-path shapes (``layers`` calls of each such case); under
    ``streaming``, per step of its streaming main path (``stream_layers``
    calls of each streaming-shape case)."""
    main_rows = [r for r in rows if r["dtype"] == "bfloat16" and r["layers"]]
    stream_rows = [r for r in rows if r["dtype"] == "bfloat16" and r["stream_layers"]]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms")
    per_batch = {key: sum(r[key] * r["layers"] for r in main_rows) for key in keys}
    per_step = {key: sum(r[key] * r["stream_layers"] for r in stream_rows) for key in keys}

    def library(key, rows_, count):
        xs = [r.get(key) for r in rows_]
        return None if None in xs else sum(x * r[count] for x, r in zip(xs, rows_))

    return {
        "launches_per_batch": sum(r["layers"] for r in main_rows),
        **per_batch,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in main_rows)
                     else "operations"),
        "library_ms": library("library_ms", main_rows, "layers"),
        "library_device_ms": library("library_device_ms", main_rows, "layers"),
        "streaming": {
            "launches_per_step": sum(r["stream_layers"] for r in stream_rows),
            **{f"{key}_per_step": v for key, v in per_step.items()},
            "library_ms_per_step": library("library_ms", stream_rows, "stream_layers"),
        },
    }


def kernel_line(name, source, replaces, launches, rows, worst, per):
    """One kernel's entry.  ``by_family`` holds ``_family_sums`` for each
    family whose main paths call it; the headline numbers are the first
    family's (``per`` says which).  ``ms``, ``plain_ms`` and ``library_ms``
    are CUDA events around one call; ``device_ms`` and ``library_device_ms``
    the device time per call with the queue kept full (``device_ms``)."""
    by_family = {}
    for r in rows:
        by_family.setdefault(r["family"], []).append(r)
    by_family = {f: _family_sums(rs) for f, rs in by_family.items()}
    head = next(iter(by_family.values()))
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": worst,
        **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms", "streaming")},
        "per": per,
        "by_family": by_family,
    }


def greedy_kernel_line(rows, plans) -> dict:
    """rnnt_greedy's entry: the headline numbers are the offline bf16 case
    (one launch per 16 x 30 s batch of the main path), ``streaming`` the bf16
    streaming step's; ``max_abs_err`` the worst float32 dec_proj error
    against the plain version (every other field exact; bf16 is held by the
    replay, its frames decided otherwise counted in ``cases``); ``plans``
    each case's shared memory and residency."""
    def pick(case):
        return next(r for r in rows if r["case"] == case and r["dtype"] == "bfloat16")

    head, step = pick("offline"), pick("streaming")
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    return {
        "name": "rnnt_greedy",
        "route": "cuda",
        "source": "k2transducerasr_tpu_torch/csrc/rnnt_greedy.cu",
        "replaces": "k2transducerasr_tpu/decode/rnnt_greedy.py:138",
        "launches": sum(GREEDY_PATHS.values()),
        "launches_by_path": dict(GREEDY_PATHS),
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        **{k: head[k] for k in keys},
        "library_ms": None,
        "streaming": {f"{k}_per_step": step[k] for k in keys},
        "plans": plans,
        "per": "one greedy search of a 16 x 30 s batch (B=16, T=766, J=512, V=500, bf16, "
               "random weights: an emission on most frames; one cluster of 8 blocks per "
               "lane); streaming: one step of 16 lanes "
               "(T = one window's encoder frames); launches: one per offline batch and per "
               "streaming step of every transducer greedy path, per rank in [12] "
               "(launches_by_path); library_ms null: no PyTorch call runs a greedy search",
        "cases": rows,
    }


def beam_kernel_line(rows, plans) -> dict:
    """rnnt_beam's entry: the headline numbers are the offline bf16 case (one
    launch per 16 x 30 s batch of the beam main path), ``streaming`` the bf16
    streaming step's; ``max_abs_err`` the worst float32 score error against
    the plain version (every other field and every recorded choice exact;
    bf16 is held by the beam replay, its steps decided otherwise counted in
    ``cases``); ``plans`` each case's shared memory and residency."""
    def pick(case):
        return next(r for r in rows if r["case"] == case and r["dtype"] == "bfloat16")

    head, step = pick("offline"), pick("streaming")
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    return {
        "name": "rnnt_beam",
        "route": "cuda",
        "source": "k2transducerasr_tpu_torch/csrc/rnnt_beam.cu",
        "replaces": "k2transducerasr_tpu/decode/rnnt_beam.py:160",
        "launches": sum(BEAM_PATHS.values()),
        "launches_by_path": dict(BEAM_PATHS),
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        **{k: head[k] for k in keys},
        "library_ms": None,
        "streaming": {f"{k}_per_step": step[k] for k in keys},
        "plans": plans,
        "per": f"one modified beam search of a 16 x 30 s batch (B=16, T=766, K={BEAM_K}, "
               "J=512, V=500, bf16, random weights; P lanes on each cluster of 8 blocks, "
               f"P={head['lanes_per_cluster']} here: {head['clusters']} clusters, "
               f"{head['waves']} wave(s)); "
               "streaming: one step of 16 lanes (T = one window's encoder frames); launches: "
               "one per offline batch and per streaming step of every transducer beam path "
               "(launches_by_path); library_ms null: no PyTorch call runs a beam search",
        "cases": rows,
    }


def mutation_check() -> int:
    """Each of MUTATIONS, in a throwaway copy, must make its phase fail."""
    import shutil

    caught = 0
    for label, rel, old, new, phase in MUTATIONS:
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(REPO, "k2transducerasr_tpu_torch"),
                            os.path.join(tmp, "k2transducerasr_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(os.path.abspath(__file__), tmp)
            path = os.path.join(tmp, rel)
            with open(path) as f:
                src = f.read()
            if old not in src:
                raise AssertionError(f"mutation {label!r}: {old!r} not in {rel}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
            code = ("import chip_smoke as c; c.phase_card(); c.phase_build(); "
                    f"c.{phase}(c.card_bandwidth(c.torch.cuda.get_device_name(0)))")
            proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, capture_output=True,
                                  text=True, timeout=900)
            last = (proc.stderr.strip().splitlines() or [""])[-1]
            hit = proc.returncode != 0 and "disagrees with plain" in last
            caught += hit
            log(f"[mutation] {label}: exit {proc.returncode}, "
                f"{'caught' if hit else 'NOT caught'}: {last[:300]}")
    log(f"[mutation] {caught} of {len(MUTATIONS)} caught")
    return 0 if caught == len(MUTATIONS) else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--mutation-check"]:
        return mutation_check()
    if sys.argv[1:] == ["--stage-splits"]:  # [6b]'s splits, in a process of their own
        return stage_splits()
    if sys.argv[1:2] == ["--parallel-rank"]:  # one rank of [12]
        return parallel_rank(sys.argv[2], int(sys.argv[3]))
    t_start = time.time()
    phase_card()
    bw = card_bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    k1_rows, k1_worst = phase_k1(bw)
    k2_rows, k2_worst = phase_k2(bw)
    greedy_rows, greedy_plans = phase_greedy(bw)
    beam_rows, beam_plans = phase_beam(bw)
    swoosh_rows, swoosh_worst = phase_swoosh(bw)
    conv_rows = phase_conv_tf32(bw)
    pins = {family: {"pin_offline": phase_golden(family), "pin_online": phase_online_pin(family)}
            for family in FAMILIES}
    pin_beam = {family: phase_beam_pins(family) for family in BEAM_PINS}
    wide_heads = phase_full_width_vs_cpu("conformer", ConformerConfig(num_heads=WIDE_HEADS),
                                         f"conformer-{WIDE_HEADS}x{WIDE_HEAD}", "[4b]")
    for family in FAMILIES:
        phase_full_width_vs_cpu(family)
        phase_streaming_vs_cpu(family)
    phase_beam_full_width_vs_cpu("zipformer2")
    offline = []

    def main_path(*args, **kw):
        n, row = phase_main_path(*args, **kw)
        offline.append(row)
        return n

    launches = {family: main_path(family) for family in FAMILIES}
    launches_beam = main_path("zipformer2", BEAM)
    splits = phase_stage_splits()
    streaming = {family: phase_streaming_main_path(family, splits) for family in FAMILIES}
    streaming_beam = phase_streaming_main_path("zipformer2", splits, BEAM)
    no_wait = phase_no_wait()
    graph_memory = phase_graph_memory()
    for family in INT8_FAMILIES:
        phase_int8_vs_cpu(family)
    launches_int8 = {family: main_path(family, accuracy="int8") for family in INT8_FAMILIES}
    streaming_int8 = phase_streaming_main_path("zipformer2", splits, accuracy="int8")
    int_mm = phase_int_mm(bw)
    ingest_launches = phase_ingest()
    with tempfile.TemporaryDirectory() as tmp:
        converted_launches, convert_s = phase_convert(tmp)
        cli_launches = phase_cli(tmp)
        par_launches = phase_parallel(tmp)
    print(json.dumps({"conv_tf32": conv_rows, "conv_tf32_paths": CONV_TF32_PATHS}), flush=True)
    print(json.dumps({"offline": offline,
                      "streaming": list(streaming.values()) + [streaming_beam, streaming_int8],
                      "int_mm": int_mm, "convert_host_s": convert_s, "no_wait": no_wait,
                      "graph_memory": graph_memory}),
          flush=True)

    def paths(family):
        return {"offline": launches[family], "streaming": streaming[family]["launches"],
                **pin_beam[family]}

    k1_paths = dict(paths("zipformer2"), offline_beam=launches_beam,
                    offline_ctc=launches["zipformer2ctc"],
                    streaming_beam=streaming_beam["launches"],
                    streaming_ctc=streaming["zipformer2ctc"]["launches"],
                    zipformer_offline=launches["zipformer"],
                    zipformer_streaming=streaming["zipformer"]["launches"],
                    **{f"zipformer_{k}": n for k, n in pins["zipformer"].items()},
                    int8_offline=launches_int8["zipformer2"],
                    int8_streaming=streaming_int8["launches"],
                    ingest_pin=ingest_launches, converted_offline=converted_launches,
                    **cli_launches, **par_launches["relpos_attn_probs"])

    kernels = [
        kernel_line("relpos_attn_probs", "k2transducerasr_tpu_torch/csrc/relpos_attn_probs.cu",
                    "k2transducerasr_tpu/ops/attention_pallas.py:158", k1_paths,
                    k1_rows, k1_worst,
                    "one zipformer2 flagship batch (16 x 30 s): 16 calls at the bf16 stack "
                    "shapes, under greedy, beam (offline_beam) and CTC (offline_ctc) alike; "
                    "streaming: one step of 16 lanes of Zipformer2Config(causal=True), "
                    "16 calls at the six stacks' (T, S); by_family.zipformer: one "
                    "ZipformerConfig() batch, 15 calls at H=8 qd=24 (T = 1532 ... 192), and "
                    "one step of 16 lanes of ZipformerConfig(causal=True), 15 calls at "
                    "(T, S) = (16, 80) ... (2, 10); its offline, streaming and pin launches are "
                    "the zipformer_* paths; int8_offline and int8_streaming: the same main "
                    "paths under accuracy='int8' (its K1 shapes unchanged); ingest_pin: the "
                    "zipformer2 pin dir's two decodes in [9]; converted_offline: one 5 s "
                    "decode of the converted full-width dir in [10]; cli_*/demo_*: [11]'s runs "
                    "on the zipformer2 pin dir (2 layers: 2 calls per decode or step); "
                    "tp_offline, dp_offline, dp_streaming: [12]'s runs on meshes 1x2 and 2x1, "
                    "summed over the 2 ranks (16 calls per rank per batch of Zipformer2Config()); "
                    "library_ms null: no PyTorch call returns rel-pos probs"),
        kernel_line("relpos_attn_ctx", "k2transducerasr_tpu_torch/csrc/relpos_attn_ctx.cu",
                    "k2transducerasr_tpu/ops/attention_pallas.py:242",
                    dict(paths("conformer"), int8_offline=launches_int8["conformer"],
                         wide_heads_offline=wide_heads, **par_launches["relpos_attn_ctx"]),
                    k2_rows, k2_worst,
                    "one conformer flagship batch (16 x 30 s): 12 calls at B=16 T=S=767 H=8 "
                    "d=64 bf16 (int8_offline: the same under accuracy='int8'); streaming: one "
                    "step of 16 lanes of ConformerConfig(causal=True),"
                    " 12 calls at T=16 S=80; wide_heads_offline: [4b]'s 5 s decode of "
                    "ConformerConfig(num_heads=4), heads of 128 (cases heads-4x128 time them); "
                    "tp_offline: [12]'s mesh 1x2 run, 12 calls per rank "
                    "per batch, summed over the 2 ranks; library_ms: "
                    "scaled_dot_product_attention with the skewed position bias precomputed "
                    "(not timed)"),
        greedy_kernel_line(greedy_rows, greedy_plans),
        beam_kernel_line(beam_rows, beam_plans),
        kernel_line("bias_swoosh", "k2transducerasr_tpu_torch/csrc/bias_swoosh.cu",
                    "none: XLA fused the bias, the Swoosh and the cast on the TPU",
                    dict(SWOOSH_PATHS), swoosh_rows, swoosh_worst,
                    "one longform batch (20 x 30 s of Zipformer2Config(), bf16): 84 calls "
                    "(48 feed-forwards, 32 conv modules, 3 embed convs, the ConvNeXt) at "
                    "[3e]'s shapes; streaming: one offpeak step of 820 lanes of "
                    "Zipformer2Config(causal=True), 84 calls; launches: every zipformer2 and "
                    "zipformer2-CTC path (launches_by_path; 84 per flagship batch or step, "
                    "5 per layer + 4 at the pin dirs' widths); library_ms null: no PyTorch "
                    "call computes a Swoosh"),
    ]
    log(f"[7] total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

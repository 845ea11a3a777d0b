"""On the card (marker ``cuda``; skips without one): the zipformer v1 cell's
step graph at its full widths (``zipformer1_librispeech_streaming`` on the
``offpeak`` pool of 820 lanes).  One replay launches K1
(``relpos_attn_probs``) once a layer, 15 times, G (``rnnt_greedy``) once
and the two scoped convs of the embed (conv2 8 -> 32, conv3 32 -> 128,
``ops/layers.py::conv_tf32``), as the counters and the profiler's trace
show, with the stage markers fbank, encoder, freeze, search, end in that
order; K2, S and LN do not run.  Its freeze passes the whole pool's
encoder state: ``online.freeze_bytes`` adds 820 lanes times
``state_bytes``.

    python -m pytest --noconftest -m cuda -s asrbench/tests/test_asrbench_zipformer1_cuda.py
"""

import json
import os

import pytest

from asrbench.core import audio, spec, system, weights

CELL = "z1_stream_offpeak"


@pytest.mark.cuda
def test_one_step_replay_runs_15_k1_1_g_2_scoped_convs_and_freezes_the_pool():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k2transducerasr_tpu_torch.decode import rnnt_greedy
    from k2transducerasr_tpu_torch.ops import activations_cuda, attention_cuda, layers, norm_cuda
    from k2transducerasr_tpu_torch.utils import profiling

    cell = spec.load_cell(os.path.dirname(spec.BENCH_DIR), CELL)
    cfg = dict(cell.config)
    lanes = int(cell.traffic["max_lanes"])
    cfg["recognizer"] = dict(cfg["recognizer"], max_lanes=lanes)
    model = spec.model(cfg)
    tree = weights.make_tree(system.init_fns(cfg), 2**31 + 29, "cuda", model.CONSTANT_RANGES)
    rec = system.build(cfg, tree, "cuda")
    pcm = audio.as_float(audio.clips(1, rec.window_samples + 2 * rec.hop_samples, 2**31 + 31,
                                     "cuda"))
    st = rec.create_online_stream()
    st.add_samples(pcm[0])
    rec.end_step(rec.begin_step([st]))  # the warm-up and the capture
    (entry,) = rec.program.entries.values()
    counters = (attention_cuda.relpos_attn_probs, rnnt_greedy.greedy_frames_skip,
                layers.conv_tf32, attention_cuda.relpos_attn_ctx, activations_cuda.bias_swoosh,
                norm_cuda.layernorm)
    before = [c.launches for c in counters]
    frozen = profiling.counters().get("online.freeze_bytes", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = rec.end_step(rec.begin_step([st]))
        torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA]
    marks = [x[len(profiling.MARKER_PREFIX):] for x in names
             if x.startswith(profiling.MARKER_PREFIX)]
    moved = profiling.counters()["online.freeze_bytes"] - frozen
    print(json.dumps({"launches": list(entry.launches), "launched": launched, "marks": marks,
                      "k1": sum("relpos_attn_probs" in x for x in names),
                      "g": sum("rnnt_greedy" in x for x in names), "freeze_bytes": moved,
                      "tokens": len(res[0].tokens)}))
    assert launched == [15, 1, 2, 0, 0, 0]
    assert marks == ["fbank", "encoder", "freeze", "search", "end"]
    assert sum("relpos_attn_probs" in x for x in names) == 15
    assert sum("rnnt_greedy" in x for x in names) == 1
    assert not any(k in x for x in names
                   for k in ("relpos_attn_ctx", "bias_swoosh", "k2t_layernorm"))
    assert moved == lanes * model.state_bytes(cfg) == lanes * 2_093_636

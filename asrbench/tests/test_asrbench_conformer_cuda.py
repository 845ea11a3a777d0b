"""On the card (marker ``cuda``; skips without one): the conformer cell's
one graph key at its full widths (``conformer_librispeech_offline``, 20 x
30 s, 3000 frames padded to 3072, T = 767 after the embed).  One replay of
its CUDA graph launches K2 (``relpos_attn_ctx``) once a layer, 12 times,
and G (``rnnt_greedy``) once, as the counters and the profiler's trace both
show, with the stage markers fbank, encoder, search, end in that order; K1
and S do not run.

    python -m pytest --noconftest -m cuda -s asrbench/tests/test_asrbench_conformer_cuda.py
"""

import json
import os

import pytest

from asrbench.core import audio, spec, system, traffic, weights

CELL = "conf_offline_longform"


@pytest.mark.cuda
def test_one_replay_runs_12_k2_and_1_g_with_the_markers_in_order():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k2transducerasr_tpu_torch.decode import rnnt_greedy
    from k2transducerasr_tpu_torch.ops import activations_cuda, attention_cuda
    from k2transducerasr_tpu_torch.utils import profiling

    cell = spec.load_cell(os.path.dirname(spec.BENCH_DIR), CELL)
    cfg, mix = cell.config, cell.traffic
    tree = weights.make_tree(system.init_fns(cfg), 2**31 + 29, "cuda",
                             spec.model(cfg).CONSTANT_RANGES)
    rec = system.build(cfg, tree, "cuda")
    n = traffic.seconds_to_samples(mix["segment_s"], cfg["frontend"]["sample_rate"])
    pcm = audio.as_float(audio.clips(int(mix["rows"]), n, 2**31 + 31, "cuda"))
    streams = []
    for row in pcm:
        s = rec.create_offline_stream()
        s.add_samples(row)
        streams.append(s)
    rec.end_decode(rec.begin_decode(streams))  # the warm-up and the capture
    (entry,) = rec.program.entries.values()
    counters = (attention_cuda.relpos_attn_ctx, rnnt_greedy.greedy_frames_skip,
                attention_cuda.relpos_attn_probs, activations_cuda.bias_swoosh)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = rec.end_decode(rec.begin_decode(streams))
        torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [12, 1, 0, 0]
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA]
    marks = [x[len(profiling.MARKER_PREFIX):] for x in names
             if x.startswith(profiling.MARKER_PREFIX)]
    print(json.dumps({"launches": list(entry.launches), "marks": marks,
                      "k2": sum("relpos_attn_ctx" in x for x in names),
                      "g": sum("rnnt_greedy" in x for x in names),
                      "tokens": [len(r.tokens) for r in res]}))
    assert marks == ["fbank", "encoder", "search", "end"]
    assert sum("relpos_attn_ctx" in x for x in names) == 12
    assert sum("rnnt_greedy" in x for x in names) == 1
    assert not any("relpos_attn_probs" in x or "bias_swoosh" in x for x in names)
    assert len(res) == int(mix["rows"])

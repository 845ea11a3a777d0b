// Stage markers (utils/profiling.py::stage): one empty kernel per stage
// boundary of an offline decode or a streaming step.  Launched on the
// caller's stream, a marker sits in stream order between the last kernel of
// one stage and the first of the next; captured into a CUDA graph it is a
// kernel node, so every replay carries it into a device trace under its
// name.  Each name is its own extern "C" kernel so that the trace shows it
// unmangled: k2t_stage_fbank, _encoder, _freeze, _search and _end, in the
// order of profiling.STAGES.

#include <cuda_runtime.h>

extern "C" __global__ void k2t_stage_fbank() {}
extern "C" __global__ void k2t_stage_encoder() {}
extern "C" __global__ void k2t_stage_freeze() {}
extern "C" __global__ void k2t_stage_search() {}
extern "C" __global__ void k2t_stage_end() {}

// Launch marker `which` (an index into profiling.STAGES) on `stream`; returns
// the launch's cudaError_t (cudaErrorInvalidValue for an index out of range).
extern "C" int k2t_stage_mark(int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: k2t_stage_fbank<<<1, 1, 0, st>>>(); break;
    case 1: k2t_stage_encoder<<<1, 1, 0, st>>>(); break;
    case 2: k2t_stage_freeze<<<1, 1, 0, st>>>(); break;
    case 3: k2t_stage_search<<<1, 1, 0, st>>>(); break;
    case 4: k2t_stage_end<<<1, 1, 0, st>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Native audio ingest for k2transducerasr_tpu_torch (the host side of the
// PyTorch port; a copy of the JAX package's native/audio_native.cpp).
//
// RIFF/WAVE decode to mono float32, linear resampling with the reference's
// interpolation semantics (AudioHelper.cs:187-284), and a per-stream sample
// ring buffer backing OnlineStream so chunk windows are extracted without
// per-chunk heap churn.
//
// C ABI only, loaded via ctypes.  native/__init__.py builds it with
//   g++ -O3 -shared -fPIC -std=c++17 audio_native.cpp -o libk2taudio.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Parse a RIFF/WAVE buffer.  Two-call pattern: out == nullptr returns the
// required number of mono samples; second call fills `out`.
// Returns sample count, or -1 on malformed input, -2 on unsupported codec.
long long k2t_wav_decode(const uint8_t* data, long long n, float* out,
                         int* sample_rate_out) {
  if (n < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  long long pos = 12;
  int fmt_tag = 0, channels = 0, rate = 0, bits = 0;
  const uint8_t* body = nullptr;
  long long body_len = 0;
  while (pos + 8 <= n) {
    uint32_t size;
    memcpy(&size, data + pos + 4, 4);
    const uint8_t* chunk = data + pos + 8;
    if ((long long)(pos + 8 + size) > n) size = (uint32_t)(n - pos - 8);
    if (memcmp(data + pos, "fmt ", 4) == 0 && size >= 16) {
      uint16_t tag, ch, bps;
      uint32_t sr;
      memcpy(&tag, chunk, 2);
      memcpy(&ch, chunk + 2, 2);
      memcpy(&sr, chunk + 4, 4);
      memcpy(&bps, chunk + 14, 2);
      fmt_tag = tag; channels = ch; rate = (int)sr; bits = bps;
    } else if (memcmp(data + pos, "data", 4) == 0) {
      body = chunk;
      body_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!body || channels <= 0) return -1;
  if (fmt_tag != 1 && fmt_tag != 3 && fmt_tag != 0xFFFE) return -2;

  long long frames;
  int bytes = bits / 8;
  if (bytes <= 0) return -1;
  frames = body_len / (bytes * channels);
  if (sample_rate_out) *sample_rate_out = rate;
  if (!out) return frames;

  for (long long i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = body + (i * channels + c) * bytes;
      double v = 0.0;
      if (fmt_tag == 3 || (fmt_tag == 0xFFFE && bits == 32)) {
        float f;
        memcpy(&f, p, 4);
        v = f;
      } else if (bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      } else if (bits == 24) {
        int32_t s = (int32_t)(p[0] | (p[1] << 8) | ((int8_t)p[2] << 16));
        v = s / 8388608.0;
      } else if (bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      }
      acc += v;
    }
    out[i] = (float)(acc / channels);
  }
  return frames;
}

// ---------------------------------------------------------------------------
// Linear resampler (AudioHelper.cs:187-284 semantics)
// ---------------------------------------------------------------------------

long long k2t_resample_linear(const float* in, long long n, int src_rate,
                              int dst_rate, float* out) {
  long long n_out = (long long)((double)n * dst_rate / src_rate);
  if (!out) return n_out;
  double step = (double)src_rate / dst_rate;
  for (long long i = 0; i < n_out; i++) {
    double pos = i * step;
    long long i0 = (long long)pos;
    if (i0 >= n - 1) {
      out[i] = in[n - 1];
      continue;
    }
    double frac = pos - i0;
    out[i] = (float)(in[i0] * (1.0 - frac) + in[i0 + 1] * frac);
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Streaming sample ring buffer (backs OnlineStream)
// ---------------------------------------------------------------------------

struct RingBuffer {
  std::vector<float> buf;
  size_t head = 0;  // read offset
  size_t tail = 0;  // write offset (count of total floats is tail-head)
};

void* k2t_rb_create(long long initial_capacity) {
  auto* rb = new RingBuffer();
  rb->buf.reserve((size_t)std::max((long long)4096, initial_capacity));
  return rb;
}

void k2t_rb_free(void* h) { delete (RingBuffer*)h; }

void k2t_rb_push(void* h, const float* data, long long n) {
  auto* rb = (RingBuffer*)h;
  // compact when the dead prefix dominates
  if (rb->head > 0 && rb->head * 2 > rb->buf.size()) {
    rb->buf.erase(rb->buf.begin(), rb->buf.begin() + rb->head);
    rb->head = 0;
  }
  rb->buf.insert(rb->buf.end(), data, data + n);
}

long long k2t_rb_size(void* h) {
  auto* rb = (RingBuffer*)h;
  return (long long)(rb->buf.size() - rb->head);
}

// Copy the first `win` available samples into out (no consume).
// Returns 0 on success, -1 if fewer than win samples are available.
int k2t_rb_window(void* h, float* out, long long win) {
  auto* rb = (RingBuffer*)h;
  if ((long long)(rb->buf.size() - rb->head) < win) return -1;
  memcpy(out, rb->buf.data() + rb->head, (size_t)win * sizeof(float));
  return 0;
}

void k2t_rb_advance(void* h, long long hop) {
  auto* rb = (RingBuffer*)h;
  rb->head = std::min(rb->buf.size(), rb->head + (size_t)hop);
}

}  // extern "C"

// Universal compressed-media decode (+ fixture encode) via the host ffmpeg
// libraries (libavformat/libavcodec/libswresample), C ABI for ctypes.
//
// This is the host analog of the reference's MediaFoundation routing
// (K2TransducerAsr.Examples/Utils/AudioHelper.cs:41-78): any container or
// codec the host media stack understands (ogg/vorbis, flac, mp4/aac, mp3,
// wav, ...) decodes through one path to mono float32 PCM at the source
// sample rate.  Built as its own shared library so the core audio runtime
// (audio_native.cpp) keeps zero external dependencies.
//
// API (all return <0 / NULL on error):
//   k2t_media_decode(path, &n, &rate) -> handle owning n mono f32 samples
//   k2t_media_copy(handle, out)       -> copy samples into caller buffer
//   k2t_media_free(handle)
//   k2t_media_encode(path, pcm, n, rate) -> encode mono f32 to `path`,
//       container/codec inferred from the extension (test fixtures + CLI).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Decoded {
  std::vector<float> pcm;
  int rate = 0;
};

// Convert one decoded frame to mono f32 at the source rate and append.
int append_frame(SwrContext* swr, const AVFrame* frame, std::vector<float>* out) {
  const int max_out = frame->nb_samples + 256;
  std::vector<float> buf(max_out);
  uint8_t* dst[1] = {reinterpret_cast<uint8_t*>(buf.data())};
  int got = swr_convert(swr, dst, max_out,
                        const_cast<const uint8_t**>(frame->extended_data),
                        frame->nb_samples);
  if (got < 0) return got;
  out->insert(out->end(), buf.begin(), buf.begin() + got);
  return 0;
}

}  // namespace

extern "C" {

void* k2t_media_decode(const char* path, long long* n_out, int* rate_out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return nullptr;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (si < 0 || !codec) {
    avformat_close_input(&fmt);
    return nullptr;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  if (!ctx || avcodec_parameters_to_context(ctx, fmt->streams[si]->codecpar) < 0 ||
      avcodec_open2(ctx, codec, nullptr) < 0) {
    if (ctx) avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return nullptr;
  }

  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (ctx->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &ctx->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  SwrContext* swr = nullptr;
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, ctx->sample_rate,
                          &in_layout, ctx->sample_fmt, ctx->sample_rate, 0,
                          nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return nullptr;
  }

  auto* dec = new Decoded();
  dec->rate = ctx->sample_rate;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  bool ok = true;
  while (ok && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == si) {
      if (avcodec_send_packet(ctx, pkt) == 0) {
        while (avcodec_receive_frame(ctx, frame) == 0) {
          if (append_frame(swr, frame, &dec->pcm) < 0) ok = false;
        }
      }
    }
    av_packet_unref(pkt);
  }
  // drain decoder + resampler
  avcodec_send_packet(ctx, nullptr);
  while (avcodec_receive_frame(ctx, frame) == 0) {
    if (append_frame(swr, frame, &dec->pcm) < 0) ok = false;
  }
  {
    std::vector<float> tail(4096);
    uint8_t* dst[1] = {reinterpret_cast<uint8_t*>(tail.data())};
    int got = swr_convert(swr, dst, (int)tail.size(), nullptr, 0);
    if (got > 0) dec->pcm.insert(dec->pcm.end(), tail.begin(), tail.begin() + got);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);

  if (!ok || dec->pcm.empty()) {
    delete dec;
    return nullptr;
  }
  *n_out = (long long)dec->pcm.size();
  *rate_out = dec->rate;
  return dec;
}

void k2t_media_copy(void* handle, float* out) {
  auto* dec = static_cast<Decoded*>(handle);
  std::memcpy(out, dec->pcm.data(), dec->pcm.size() * sizeof(float));
}

void k2t_media_free(void* handle) { delete static_cast<Decoded*>(handle); }

// Encode mono f32 PCM to `path`; container + codec chosen by ffmpeg from
// the extension (.ogg -> vorbis, .flac -> flac, .m4a/.mp4 -> aac, ...).
// Primarily for test fixtures and the examples CLI.
int k2t_media_encode(const char* path, const float* pcm, long long n, int rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  if (!ctx) {
    avformat_free_context(fmt);
    return -3;
  }
  ctx->sample_rate = rate;
  av_channel_layout_default(&ctx->ch_layout, 1);
  ctx->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
  // vorbis rejects bitrates outside its per-mode envelope for mono/16 kHz;
  // 64 kbps is inside every encoder's envelope at speech rates
  ctx->bit_rate = 64000;
  ctx->time_base = {1, rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(ctx, codec, nullptr) < 0) goto fail;

  {
    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st || avcodec_parameters_from_context(st->codecpar, ctx) < 0) goto fail;
    st->time_base = ctx->time_base;

    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
      goto fail;
    if (avformat_write_header(fmt, nullptr) < 0) goto fail;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    SwrContext* swr = nullptr;
    if (swr_alloc_set_opts2(&swr, &ctx->ch_layout, ctx->sample_fmt, rate, &mono,
                            AV_SAMPLE_FMT_FLT, rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0) {
      if (swr) swr_free(&swr);
      goto fail;
    }

    const int fsz = ctx->frame_size > 0 ? ctx->frame_size : 1024;
    AVFrame* frame = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    long long pos = 0;
    int64_t pts = 0;
    int err = 0;
    while (pos < n && err == 0) {
      int take = (int)((n - pos) < fsz ? (n - pos) : fsz);
      frame->nb_samples = take;
      frame->format = ctx->sample_fmt;
      av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
      frame->sample_rate = rate;
      if (av_frame_get_buffer(frame, 0) < 0) {
        err = -5;
        break;
      }
      const uint8_t* src[1] = {reinterpret_cast<const uint8_t*>(pcm + pos)};
      if (swr_convert(swr, frame->extended_data, take, src, take) < 0) {
        err = -6;
        break;
      }
      frame->pts = pts;
      pts += take;
      pos += take;
      if (avcodec_send_frame(ctx, frame) == 0) {
        while (avcodec_receive_packet(ctx, pkt) == 0) {
          av_packet_rescale_ts(pkt, ctx->time_base, fmt->streams[0]->time_base);
          pkt->stream_index = 0;
          if (av_interleaved_write_frame(fmt, pkt) < 0) err = -7;
        }
      }
      av_frame_unref(frame);
    }
    // flush encoder
    avcodec_send_frame(ctx, nullptr);
    while (avcodec_receive_packet(ctx, pkt) == 0) {
      av_packet_rescale_ts(pkt, ctx->time_base, fmt->streams[0]->time_base);
      pkt->stream_index = 0;
      av_interleaved_write_frame(fmt, pkt);
    }
    av_write_trailer(fmt);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    swr_free(&swr);
    if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
    avcodec_free_context(&ctx);
    avformat_free_context(fmt);
    return err;
  }

fail:
  if (fmt->pb && !(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avcodec_free_context(&ctx);
  avformat_free_context(fmt);
  return -4;
}

}  // extern "C"

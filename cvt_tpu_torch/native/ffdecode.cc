// In-memory video decoder over libavformat/libavcodec — the native
// equivalent of the reference's FFDecoder custom-AVIOContext memory
// decode (ffmpeg_read_memory/include/ffdecoder.h:18-59,
// src/ffdecoder.cpp `read_buffer` callback): open from a file path OR a
// raw byte buffer, iterate frames as GRAY8 planes. C ABI for ctypes.
//
// Unlike round 2's temp-file staging, the buffer path never touches the
// filesystem: a custom AVIOContext serves reads/seeks straight from the
// caller's bytes (copied once at open so Python lifetimes don't
// matter).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

struct FfDec {
  AVFormatContext* fmt = nullptr;
  AVIOContext* avio = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  uint8_t* buf = nullptr;      // owned copy of the caller's bytes
  int64_t size = 0;
  int64_t pos = 0;
  int stream_idx = -1;
  int w = 0, h = 0;
  bool draining = false;
};

int read_cb(void* opaque, uint8_t* out, int n) {
  FfDec* d = static_cast<FfDec*>(opaque);
  int64_t rem = d->size - d->pos;
  if (rem <= 0) return AVERROR_EOF;
  if (n > rem) n = static_cast<int>(rem);
  std::memcpy(out, d->buf + d->pos, n);
  d->pos += n;
  return n;
}

int64_t seek_cb(void* opaque, int64_t offset, int whence) {
  FfDec* d = static_cast<FfDec*>(opaque);
  if (whence == AVSEEK_SIZE) return d->size;
  whence &= ~AVSEEK_FORCE;
  int64_t np = (whence == SEEK_SET)   ? offset
               : (whence == SEEK_CUR) ? d->pos + offset
                                      : d->size + offset;
  if (np < 0 || np > d->size) return -1;
  d->pos = np;
  return np;
}

void destroy(FfDec* d) {
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->fmt) {
    if (d->avio) d->fmt->pb = nullptr;
    avformat_close_input(&d->fmt);
  }
  if (d->avio) {
    av_freep(&d->avio->buffer);
    avio_context_free(&d->avio);
  }
  std::free(d->buf);
  delete d;
}

FfDec* open_common(FfDec* d) {
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  d->stream_idx =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_idx < 0 || !dec) {
    destroy(d);
    return nullptr;
  }
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec,
                                d->fmt->streams[d->stream_idx]->codecpar);
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  d->w = d->codec->width;
  d->h = d->codec->height;
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  return d;
}

}  // namespace

extern "C" {

void* ffdec_open_buffer(const uint8_t* data, int64_t size) {
  FfDec* d = new FfDec();
  d->buf = static_cast<uint8_t*>(std::malloc(size));
  if (!d->buf) {
    delete d;
    return nullptr;
  }
  std::memcpy(d->buf, data, size);
  d->size = size;
  unsigned char* io_buf = static_cast<unsigned char*>(av_malloc(1 << 16));
  d->avio = avio_alloc_context(io_buf, 1 << 16, 0, d, read_cb, nullptr,
                               seek_cb);
  d->fmt = avformat_alloc_context();
  d->fmt->pb = d->avio;
  if (avformat_open_input(&d->fmt, nullptr, nullptr, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  return open_common(d);
}

void* ffdec_open_file(const char* path) {
  FfDec* d = new FfDec();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  return open_common(d);
}

int ffdec_width(void* h) { return static_cast<FfDec*>(h)->w; }
int ffdec_height(void* h) { return static_cast<FfDec*>(h)->h; }

// Decode the next video frame into out[h*w] GRAY8.
// Returns 1 on frame, 0 on clean EOF, <0 on error.
int ffdec_read_gray(void* hd, uint8_t* out) {
  FfDec* d = static_cast<FfDec*>(hd);
  while (true) {
    int r = avcodec_receive_frame(d->codec, d->frame);
    if (r == 0) {
      if (!d->sws) {
        d->sws = sws_getContext(
            d->frame->width, d->frame->height,
            static_cast<AVPixelFormat>(d->frame->format), d->w, d->h,
            AV_PIX_FMT_GRAY8, SWS_BILINEAR, nullptr, nullptr, nullptr);
        if (!d->sws) return -2;
      }
      uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
      int dst_stride[4] = {d->w, 0, 0, 0};
      sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
                d->frame->height, dst, dst_stride);
      av_frame_unref(d->frame);
      return 1;
    }
    if (r == AVERROR_EOF) return 0;
    if (r != AVERROR(EAGAIN)) return -3;
    if (d->draining) return 0;
    // feed more packets
    while (true) {
      int pr = av_read_frame(d->fmt, d->pkt);
      if (pr < 0) {
        avcodec_send_packet(d->codec, nullptr);  // start drain
        d->draining = true;
        break;
      }
      if (d->pkt->stream_index == d->stream_idx) {
        int sr = avcodec_send_packet(d->codec, d->pkt);
        av_packet_unref(d->pkt);
        if (sr < 0 && sr != AVERROR(EAGAIN)) return -4;
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

void ffdec_close(void* h) { destroy(static_cast<FfDec*>(h)); }

}  // extern "C"
